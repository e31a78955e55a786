// The probe kernels: the primitives the pack kernel is made of, one
// __global__ kernel each, for `python -m tudocomp_tpu_torch.probes`.
//
// Replaces the Pallas bodies of four measurement scripts of the JAX package:
//   etc/probe3.py  gather_kernel                      -> gather_kernel
//   etc/probe6.py  roll_lane, roll_sublane, k_extract, k_bid, k_dot3, k_rmw,
//                  k_shift                            -> the seven p6_* kernels
//   etc/probe7.py  the kernels of make(level)         -> p7_pack_kernel
//   etc/probe8.py  k_a, k_b, k_c, k_d                 -> the four p8_* kernels
// Each computes what its Pallas body computes and returns the same outputs,
// in Hopper's terms. A token tile is 8 rows of 128 lanes, row-major, as in
// the scripts; here a tile is one CTA of 1024 threads, thread r * 128 + c
// holding element (r, c), except where said otherwise.
//   - The gather is designed for the card (its note below): a CTA takes
//     1024 entries of a row, reads idx and writes out in 16-byte vectors,
//     checks its bounds once from the tile's min and max, and gathers either
//     from a window of S that one TMA bulk copy brought into shared memory
//     (indices that stay close, as the probe's sorted ones) or straight from
//     device memory with all its loads in flight.
//   - The lane roll is a warp shuffle and the sublane roll a row copy: one
//     warp a row, a 16-byte vector a lane, no shared memory and no barrier.
//   - The roll scans (lane scan, then sublane scan of the row totals) are
//     one CTA-wide scan: warp shuffles, then the 32 warp totals in shared
//     memory. The segmented XOR scan per target word runs over a warp.
//   - The one-hot products on the matrix unit, which scattered counts and
//     word parts, are atomicAdd / atomicXor into shared memory.
//   - The TPU grid ran its tile axis in order and carried a scalar in SMEM
//     from one step to the next; here one CTA owns a block and loops over
//     its tiles with the carry in a register.
//   - The dynamic-slice read-modify-write of a 384-word window becomes
//     XORs at computed offsets (atomicXor where windows may overlap).
// A kernel that finds a bad input (the gather, rmw, the pack at level 1-5,
// k_d) stores 1 into `err`, a word of pinned host memory mapped for the card
// (csrc/launch.cu): a plain store, never an atomic, which the host reads
// after it has waited for the stream.
// Bound on the H100: the gather by the bytes it moves; every other kernel
// works on a few KiB and is bound by its launch and a handful of dependent
// shared-memory steps. Words are u32 bit patterns; the wrappers hand them
// over in int32 tensors.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int LANES = 128;
constexpr int TILE = ROWS * LANES;  // elements of a tile = threads of a CTA
constexpr int WIN = 384;            // the scripts' window, in words
constexpr int TILE_WIN = 1280;      // words a tile of 1024 tokens can touch from its
                                    // 128-aligned base: 127 + 1024 + 1 spill, rounded up
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Inclusive scan of one int per thread over the 1024 threads of a CTA, in
// thread order (row-major over the tile); *total gets the sum. s_warp holds
// 33 ints. Ends with a barrier, so s_warp can be reused at once.
__device__ int tile_inclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = warp_inclusive_scan(x);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int ws = s_warp[lane];
    const int wi = warp_inclusive_scan(ws);
    s_warp[lane] = wi - ws;
    if (lane == 31) s_warp[32] = wi;
  }
  __syncthreads();
  incl += s_warp[warp];
  *total = s_warp[32];
  __syncthreads();
  return incl;
}

// Inclusive scan along the 128 lanes of each row (4 warps a row).
__device__ int row_inclusive_scan(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = warp_inclusive_scan(x);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = warp & ~3; w < warp; ++w) incl += s_warp[w];
  __syncthreads();
  return incl;
}

// ---- etc/probe3.py: out[b, i] = S[b, idx[b, i]] -----------------------------
//
// Replaces gather_kernel of etc/probe3.py, which gathered one row in VMEM.
// Bound on the H100: bytes. The named words (idx read, out written, each word
// of S that idx names read once) are 51.5 MB at the probe's shape, 0.0154 ms
// at 3.35 TB/s; but idx rises ~4.9 words an entry there, so every 32-byte
// sector of S is touched and DRAM must move S + idx + out, 105 MB, 0.031 ms
// (the sector floor). One CTA takes G_TILE entries of one row:
//   - idx is read and out written in 16-byte vectors where both addresses
//     share their alignment (a scalar head and tail around them; rows of an
//     odd length start misaligned), index arithmetic 32-bit inside the row;
//   - the CTA reduces its tile's min and max once. A tile with an index
//     outside [0, ns) stores the flag word once and writes zeros (the
//     wrapper raises): no atomic per element;
//   - staged arm: when max - min + 1 <= G_STAGE_WORDS, one thread copies
//     S[b, min .. max] (widened to 16-byte bounds, clamped to the allocation)
//     into shared memory with one TMA bulk copy (cp.async.bulk, completion on
//     an mbarrier), and the tile gathers from shared memory. S then moves
//     once, in bulk, at the sector floor; sorted indices take this arm;
//   - direct arm: otherwise every thread issues the loads of all its entries
//     (read-only path) before it stores, so the idx -> S dependency does not
//     serialise them.
// The window is small on purpose: 24 KiB a CTA lets six CTAs (48 warps)
// share an SM, and the direct arm needs those warps' loads in flight. An S
// that does not start on a 16-byte bound takes the direct arm everywhere
// (chip_smoke.py times sorted indices that way against the staged arm).

constexpr int G_THREADS = 256;
constexpr int G_VECS = 1;                            // 16-byte vectors of idx a thread
constexpr int G_TILE = G_THREADS * G_VECS * 4;       // entries a CTA: 1024
constexpr int G_STAGE_WORDS = 6144;                  // the staged arm's largest span
constexpr int G_SMEM_BYTES = (G_STAGE_WORDS + 8) * 4;  // + 16-byte widening at each end
static_assert(G_SMEM_BYTES + 128 <= 48 * 1024, "past 48 KiB the launch needs cudaFuncSetAttribute");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(G_THREADS, 6)
gather_kernel(const uint32_t* __restrict__ S, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, int B, long long ns, long long ni, int stage_ok,
              int32_t* arms, int32_t* err) {
  extern __shared__ __align__(16) uint32_t win[];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int s_min[G_THREADS / 32], s_max[G_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long total = (long long)B * ns;
  const long long i0 = (long long)blockIdx.x * G_TILE;
  const int n = (int)min((long long)G_TILE, ni - i0);
  unsigned parity = 0;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const int32_t* ix = idx + b * ni + i0;
    uint32_t* o = out + b * ni + i0;
    const uint32_t* s = S + b * ns;
    // entries [0, head) and [head + 4 * nv, n) are scalars, the rest vectors
    int head = (int)(((16 - ((uintptr_t)ix & 15)) & 15) >> 2);
    if (head > n || (((uintptr_t)ix ^ (uintptr_t)o) & 15)) head = n;
    const int nv = (n - head) >> 2;
    const int n_edge = n - 4 * nv;
    const int4* iv4 = reinterpret_cast<const int4*>(ix + head);
    uint4* o4 = reinterpret_cast<uint4*>(o + head);
    auto edge = [&](int e) { return e < head ? e : e + 4 * nv; };

    int4 v[G_VECS];
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int k = 0; k < G_VECS; ++k) {
      const int q = tid + k * G_THREADS;
      if (q < nv) {
        v[k] = __ldg(iv4 + q);
        mn = min(mn, min(min(v[k].x, v[k].y), min(v[k].z, v[k].w)));
        mx = max(mx, max(max(v[k].x, v[k].y), max(v[k].z, v[k].w)));
      }
    }
    for (int e = tid; e < n_edge; e += G_THREADS) {
      const int j = __ldg(ix + edge(e));
      mn = min(mn, j);
      mx = max(mx, j);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      mn = min(mn, __shfl_xor_sync(FULL, mn, d));
      mx = max(mx, __shfl_xor_sync(FULL, mx, d));
    }
    if (lane == 0) {
      s_min[warp] = mn;
      s_max[warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < G_THREADS / 32; ++w) {
      mn = min(mn, s_min[w]);
      mx = max(mx, s_max[w]);
    }

    if (mn < 0 || (long long)mx >= ns) {
      if (tid == 0) {
        *reinterpret_cast<volatile int32_t*>(err) = 1;
        if (arms) atomicAdd(arms + 2, 1);
      }
#pragma unroll
      for (int k = 0; k < G_VECS; ++k)
        if (tid + k * G_THREADS < nv) o4[tid + k * G_THREADS] = make_uint4(0, 0, 0, 0);
      for (int e = tid; e < n_edge; e += G_THREADS) o[edge(e)] = 0;
    } else {
      const bool staged = stage_ok && mx - mn < G_STAGE_WORDS;
      // the window: words [lo, e_end) of the allocation, win[0] = S[lo]
      const long long a = b * ns + mn, e_end = b * ns + mx + 1;
      const long long lo = a & ~3LL;
      const long long hi = min((e_end + 3) & ~3LL, total & ~3LL);  // bulk copy end
      const int shift = (int)(b * ns - lo);  // win index of s[j] is j + shift
      if (staged) {
        if (tid == 0) {
          const uint32_t bytes = (uint32_t)(hi - lo) * 4u;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (bytes) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         ::"r"(smem_addr(&bar)), "r"(bytes) : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                ::"r"(smem_addr(win)), "l"(S + lo), "r"(bytes), "r"(smem_addr(&bar)) : "memory");
          } else {
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(&bar)) : "memory");
          }
          if (arms) atomicAdd(arms + 0, 1);
        }
        // the allocation's last words, past its last 16-byte bound
        for (long long w = hi + tid; w < e_end; w += G_THREADS) win[w - lo] = S[w];
        __syncthreads();
        uint32_t done = 0;
        while (!done) {
          asm volatile(
              "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              " selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done) : "r"(smem_addr(&bar)), "r"(parity) : "memory");
        }
        parity ^= 1;
      } else if (tid == 0 && arms) {
        atomicAdd(arms + 1, 1);
      }
      uint4 r[G_VECS];
#pragma unroll
      for (int k = 0; k < G_VECS; ++k) {
        if (tid + k * G_THREADS < nv) {
          if (staged)
            r[k] = make_uint4(win[v[k].x + shift], win[v[k].y + shift], win[v[k].z + shift],
                              win[v[k].w + shift]);
          else
            r[k] = make_uint4(__ldg(s + v[k].x), __ldg(s + v[k].y), __ldg(s + v[k].z),
                              __ldg(s + v[k].w));
        }
      }
#pragma unroll
      for (int k = 0; k < G_VECS; ++k)
        if (tid + k * G_THREADS < nv) o4[tid + k * G_THREADS] = r[k];
      for (int e = tid; e < n_edge; e += G_THREADS) {
        const int j = __ldg(ix + edge(e));
        o[edge(e)] = staged ? win[j + shift] : __ldg(s + j);
      }
    }
    __syncthreads();  // win, s_min, s_max are reused by the next row
  }
}

// ---- etc/probe6.py: seven primitives on one [8, 128] int32 tile -------------

// pltpu.roll(x, 1, axis=1): the TPU's lane rotation is a warp shuffle. One
// warp a row (8 warps); lane l holds elements 4l .. 4l + 3 of its row in one
// 16-byte vector, takes element 4l - 1 from lane l - 1 (mod 32) and shifts
// it in. No shared memory, no barrier.
__global__ void __launch_bounds__(ROWS * 32) p6_roll_lane_kernel(const int4* __restrict__ x,
                                                                 int4* __restrict__ o) {
  const int lane = threadIdx.x & 31;
  const int4 v = x[threadIdx.x];
  const int prev = __shfl_sync(FULL, v.w, (lane + 31) & 31);
  o[threadIdx.x] = make_int4(prev, v.x, v.y, v.z);
}

// pltpu.roll(x, 1, axis=0): row r - 1 (mod 8) copied to row r. One warp a
// row (8 warps); lane l moves 16-byte vector l of the row. No shared memory,
// no barrier.
__global__ void __launch_bounds__(ROWS * 32) p6_roll_sublane_kernel(const int4* __restrict__ x,
                                                                    int4* __restrict__ o) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  o[threadIdx.x] = x[((r + ROWS - 1) & (ROWS - 1)) * 32 + lane];
}

// every element becomes 2 * x[7, 0]: a scalar taken out of a computed vector
__global__ void __launch_bounds__(TILE) p6_extract_kernel(const int32_t* x, int32_t* o) {
  __shared__ int32_t s;
  const int tid = threadIdx.x;
  const int32_t v = x[tid] * 2;
  if (tid == 7 * LANES) s = v;
  __syncthreads();
  o[tid] = s;
}

// every row becomes its last lane
__global__ void __launch_bounds__(TILE) p6_bid_kernel(const int32_t* x, int32_t* o) {
  __shared__ int32_t last[ROWS];
  const int tid = threadIdx.x, r = tid >> 7, c = tid & 127;
  if (c == LANES - 1) last[r] = x[tid];
  __syncthreads();
  o[tid] = last[r];
}

// o[r, j] = number of lanes l of row r with x[r, l] mod 384 == j, for j < 128
// (the one-hot [8, 384, 128] x ones product, plane 0, columns 0..127)
__global__ void __launch_bounds__(TILE) p6_dot3_kernel(const int32_t* x, int32_t* o) {
  __shared__ int32_t hist[ROWS][WIN];
  const int tid = threadIdx.x, r = tid >> 7, c = tid & 127;
  for (int j = tid; j < ROWS * WIN; j += TILE) (&hist[0][0])[j] = 0;
  __syncthreads();
  atomicAdd(&hist[r][floor_mod(x[tid], WIN)], 1);
  __syncthreads();
  o[tid] = hist[r][c];
}

// o[0 .. n) = 0, then o[a .. a + 384) ^= 7 with a = (i >> 7) * 128
__global__ void __launch_bounds__(TILE) p6_rmw_kernel(const int32_t* i, uint32_t* o, int n,
                                                      int32_t* err) {
  const int tid = threadIdx.x;
  for (int j = tid; j < n; j += TILE) o[j] = 0;
  __syncthreads();
  const int a = (i[0] >> 7) * 128;
  if (a < 0 || a + WIN > n) {
    if (tid == 0) *reinterpret_cast<volatile int32_t*>(err) = 1;
    return;
  }
  for (int j = tid; j < WIN; j += TILE) o[a + j] ^= 7u;
}

// rotate left by x mod 31, as ((v << s) | (v >> (31 - s)))
__global__ void __launch_bounds__(TILE) p6_shift_kernel(const int32_t* x, int32_t* o) {
  const int tid = threadIdx.x;
  const uint32_t v = (uint32_t)x[tid];
  const uint32_t s = (uint32_t)floor_mod(x[tid], 31);
  o[tid] = (int32_t)((v << s) | (v >> (31u - s)));
}

// ---- etc/probe7.py: the pack kernel, built up in five levels -----------------
//
// One CTA per block; tiles of 1024 tokens in order, the bit offset carried.
//   level 1  scan of the widths with the running carry; total bits
//   level 2  + masked value split into the part for word off >> 5 (hi) and
//            the spill into the next word (lo)
//   level 3  + XOR scan of hi segmented by target word (over a warp); the
//            last token of each run keeps the run's word part
//   level 4  + scatter of the parts into a window in shared memory that
//            starts at the tile's 128-aligned base word
//   level 5  + the window XORed into the arena
// Only level 5 writes the arena, as in the script; `mid`, when given, takes
// what levels 2-4 computed: [B, NT, 2] (hi, lo) at level 2, the same with
// the run parts at level 3, [B, tiles, TILE_WIN] windows at level 4.
__global__ void __launch_bounds__(TILE)
p7_pack_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ nbits, int64_t nt,
               int n_wp, uint32_t* words, int32_t* bits, int level, uint32_t* mid, int32_t* err) {
  __shared__ int s_warp[33];
  __shared__ uint32_t win[TILE_WIN];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t* arena = words + b * n_wp;
  for (int j = tid; j < n_wp; j += TILE) arena[j] = 0;
  __syncthreads();
  const int n_tiles = (int)((nt + TILE - 1) / TILE);
  int carry = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t i = (int64_t)t * TILE + tid;
    int nb = 0;
    uint32_t v = 0;
    if (i < nt) {
      nb = nbits[b * nt + i];
      v = vals[b * nt + i];
      if (nb < 0 || nb > 32) {
        *reinterpret_cast<volatile int32_t*>(err) = 1;
        nb = 0;
      }
    }
    int total;
    const int incl = tile_inclusive_scan(nb, s_warp, &total);
    const int c0 = carry;
    const int off = c0 + incl - nb;
    carry = c0 + total;
    if (level == 1) continue;

    const uint32_t mask = nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u);
    const uint32_t vm = v & mask;
    const int sh_end = (off & 31) + nb;
    uint32_t hi = 0, lo = 0;
    if (nb > 0) {
      if (sh_end <= 32) {
        hi = vm << (32 - sh_end);
      } else {
        hi = vm >> (sh_end - 32);
        lo = vm << (64 - sh_end);
      }
    }
    const int w0 = off >> 5;
    if (level == 2) {
      if (mid != nullptr && i < nt) {
        mid[(b * nt + i) * 2] = hi;
        mid[(b * nt + i) * 2 + 1] = lo;
      }
      continue;
    }

    const int w0_prev = __shfl_up_sync(FULL, w0, 1);
    const int w0_next = __shfl_down_sync(FULL, w0, 1);
    uint32_t xs = hi;
    bool f = lane == 0 || w0 != w0_prev;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t xk = __shfl_up_sync(FULL, xs, d);
      const bool fk = __shfl_up_sync(FULL, (int)f, d) != 0;
      if (lane >= d) {
        if (!f) xs ^= xk;
        f = f || fk;
      }
    }
    const bool seg_last = lane == 31 || w0 != w0_next;
    const uint32_t hi_c = seg_last ? xs : 0u;
    const uint32_t lo_c = seg_last ? lo : 0u;
    if (level == 3) {
      if (mid != nullptr && i < nt) {
        mid[(b * nt + i) * 2] = hi_c;
        mid[(b * nt + i) * 2 + 1] = lo_c;
      }
      continue;
    }

    const int abase = ((c0 >> 5) >> 7) << 7;
    for (int j = tid; j < TILE_WIN; j += TILE) win[j] = 0;
    __syncthreads();
    if (hi_c) atomicXor(&win[w0 - abase], hi_c);
    if (lo_c) atomicXor(&win[w0 + 1 - abase], lo_c);
    __syncthreads();
    if (level == 4) {
      if (mid != nullptr)
        for (int j = tid; j < TILE_WIN; j += TILE)
          mid[(b * n_tiles + t) * TILE_WIN + j] = win[j];
      __syncthreads();
      continue;
    }

    for (int j = tid; j < TILE_WIN; j += TILE) {
      const int w = abase + j;
      if (win[j] != 0 && w < n_wp) arena[w] ^= win[j];
    }
    __syncthreads();
  }
  if (tid == 0) bits[b] = carry;
}

// ---- etc/probe8.py: the pack kernel's infrastructure, in four steps ----------
//
// v [B, T, 8, 128] int32; words [B, n_wp] (zeroed here, as the scripts' first
// grid step does); carry [B] is the scalar the scripts carried and never
// stored, given out so that it can be checked.

// a: the carry alone: the sum of v[b, t, 0, 0] over the tiles
__global__ void __launch_bounds__(TILE)
p8_a_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < n_wp; j += TILE) words[b * n_wp + j] = 0;
  if (tid == 0) {
    int carry = 0;
    for (int t = 0; t < T; ++t) carry += v[(b * T + t) * TILE];
    carry_out[b] = carry;
  }
}

// b: + the scans: the carry takes every tile's total
__global__ void __launch_bounds__(TILE)
p8_b_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  __shared__ int s_warp[33];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < n_wp; j += TILE) words[b * n_wp + j] = 0;
  int carry = 0;
  for (int t = 0; t < T; ++t) {
    int total;
    tile_inclusive_scan(v[(b * T + t) * TILE + tid], s_warp, &total);
    carry += total;
  }
  if (tid == 0) carry_out[b] = carry;
}

// c: the carry, read before the scan, is added into the lane scan, and row 0
// of the sum is stored in words[0 .. 128); the carry takes row 7's total
__global__ void __launch_bounds__(TILE)
p8_c_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  __shared__ int s_warp[33];
  __shared__ int s_row7;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < n_wp; j += TILE) words[b * n_wp + j] = 0;
  __syncthreads();
  int carry = 0;
  for (int t = 0; t < T; ++t) {
    const int x = row_inclusive_scan(v[(b * T + t) * TILE + tid], s_warp);
    if (tid < LANES && tid < n_wp) words[b * n_wp + tid] = (uint32_t)(carry + x);
    if (tid == TILE - 1) s_row7 = x;
    __syncthreads();
    carry += s_row7;
    __syncthreads();
  }
  if (tid == 0) carry_out[b] = carry;
}

// d: eight windowed XOR read-modify-writes a tile, at offsets taken out of a
// computed vector: words[a_g .. a_g + 384) ^= g + 1, a_g = (base[g, 0] >> 7) * 128
// with base = (v * 3) mod 8. Windows of different g may overlap: atomicXor.
__global__ void __launch_bounds__(TILE)
p8_d_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out, int32_t* err) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, g = tid >> 7, c = tid & 127;
  for (int j = tid; j < n_wp; j += TILE) words[b * n_wp + j] = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int base = floor_mod(v[(b * T + t) * TILE + g * LANES] * 3, 8);
    const int a = (base >> 7) * 128;
    if (a + WIN > n_wp) {
      if (c == 0) *reinterpret_cast<volatile int32_t*>(err) = 1;
      continue;
    }
    for (int j = c; j < WIN; j += LANES) atomicXor(&words[b * n_wp + a + j], (uint32_t)(g + 1));
  }
  if (tid == 0) carry_out[b] = 0;
}

inline int last_error() { return (int)cudaGetLastError(); }

}  // namespace

#define STREAM static_cast<cudaStream_t>(stream)
#define I32(p) static_cast<const int32_t*>(p)
#define I32W(p) static_cast<int32_t*>(p)
#define U32W(p) static_cast<uint32_t*>(p)

// S [B, ns] u32, idx [B, ni] i32 -> out [B, ni] u32. err: the mapped flag
// word, set when an index lies outside [0, ns). arms: null, or three int32
// counts on the device that each tile adds to (staged, direct, out of range).
extern "C" int tdc_probe3_gather(const void* S, const void* idx, void* out, int B, long long ns,
                                 long long ni, void* arms, void* err, void* stream) {
  if (ni <= 0 || B <= 0) return 0;
  const long long tiles = (ni + G_TILE - 1) / G_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(B < 65535 ? B : 65535));
  const int stage_ok = ((uintptr_t)S & 15) == 0;  // the bulk copy needs 16-byte bounds
  gather_kernel<<<grid, G_THREADS, G_SMEM_BYTES, STREAM>>>(static_cast<const uint32_t*>(S), I32(idx),
                                                           U32W(out), B, ns, ni, stage_ok,
                                                           I32W(arms), I32W(err));
  return last_error();
}

// x, o: one [8, 128] int32 tile each (the two rolls: 16-byte aligned).
extern "C" int tdc_probe6_roll_lane(const void* x, void* o, void* stream) {
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorMisalignedAddress;
  p6_roll_lane_kernel<<<1, ROWS * 32, 0, STREAM>>>(static_cast<const int4*>(x), static_cast<int4*>(o));
  return last_error();
}
extern "C" int tdc_probe6_roll_sublane(const void* x, void* o, void* stream) {
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorMisalignedAddress;
  p6_roll_sublane_kernel<<<1, ROWS * 32, 0, STREAM>>>(static_cast<const int4*>(x),
                                                      static_cast<int4*>(o));
  return last_error();
}
extern "C" int tdc_probe6_extract(const void* x, void* o, void* stream) {
  p6_extract_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}
extern "C" int tdc_probe6_bid(const void* x, void* o, void* stream) {
  p6_bid_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}
extern "C" int tdc_probe6_dot3(const void* x, void* o, void* stream) {
  p6_dot3_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}
// i [1] int32 on the device, o [n] u32, err the mapped flag word.
extern "C" int tdc_probe6_rmw(const void* i, void* o, int n, void* err, void* stream) {
  p6_rmw_kernel<<<1, TILE, 0, STREAM>>>(I32(i), U32W(o), n, I32W(err));
  return last_error();
}
extern "C" int tdc_probe6_shift(const void* x, void* o, void* stream) {
  p6_shift_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}

// vals, nbits [B, nt]; words [B, n_wp]; bits [B]; mid may be null; err the mapped flag word.
extern "C" int tdc_probe7_pack(const void* vals, const void* nbits, int B, long long nt, int n_wp,
                               void* words, void* bits, int level, void* mid, void* err,
                               void* stream) {
  p7_pack_kernel<<<B, TILE, 0, STREAM>>>(static_cast<const uint32_t*>(vals), I32(nbits), nt, n_wp,
                                         U32W(words), I32W(bits), level, U32W(mid), I32W(err));
  return last_error();
}

// v [B, T, 8, 128] int32; words [B, n_wp]; carry [B]; err the mapped flag word (d only).
extern "C" int tdc_probe8_a(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  p8_a_kernel<<<B, TILE, 0, STREAM>>>(I32(v), T, n_wp, U32W(words), I32W(carry));
  return last_error();
}
extern "C" int tdc_probe8_b(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  p8_b_kernel<<<B, TILE, 0, STREAM>>>(I32(v), T, n_wp, U32W(words), I32W(carry));
  return last_error();
}
extern "C" int tdc_probe8_c(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  p8_c_kernel<<<B, TILE, 0, STREAM>>>(I32(v), T, n_wp, U32W(words), I32W(carry));
  return last_error();
}
extern "C" int tdc_probe8_d(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* err, void* stream) {
  p8_d_kernel<<<B, TILE, 0, STREAM>>>(I32(v), T, n_wp, U32W(words), I32W(carry), I32W(err));
  return last_error();
}
