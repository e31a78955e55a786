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
//     word parts, are atomicAdd / atomicXor into shared memory: k_dot3's
//     into 128 counters a warp, one warp a row, probe7's into a CTA's window.
//   - The TPU grid ran its tile axis in order and carried a scalar in SMEM
//     from one step to the next; here probe8's row of tiles has one CTA for
//     its carry, which reduces what the carry needs in u32 (k_a one warp
//     over the tiles' first words, k_b the whole row, k_c only the rows
//     that carry its result, a warp a tile), and CTAs beside it store the
//     zeroed arena in 16-byte stores, each word once; the pack of probe7
//     runs all tiles at once, a CTA summing the widths before its tile.
//   - The dynamic-slice read-modify-write of a 384-word window becomes
//     each word's value computed from the windows that cover it and stored
//     once, in 16-byte stores, with no zeroing pass: for k_d the XOR of
//     every window over the word, for k_rmw 7 inside the one window and 0
//     outside it.
//   - k_shift is an elementwise pass, k_bid a broadcast of each row's last
//     word and k_extract of one doubled word, all three in the rolls' shape.
// A kernel that finds a bad input (the gather, rmw, the pack at level 1-5)
// stores 1 into `err`, a word of pinned host memory mapped for the card
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

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Inclusive scan of one value per thread over the 1024 threads of a CTA, in
// thread order (row-major over the tile); *total gets the sum. s_warp holds
// 33 values. Ends with a barrier, so s_warp can be reused at once.
template <typename T>
__device__ T tile_inclusive_scan(T x, T* s_warp, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = warp_inclusive_scan(x);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T ws = s_warp[lane];
    const T wi = warp_inclusive_scan(ws);
    s_warp[lane] = wi - ws;
    if (lane == 31) s_warp[32] = wi;
  }
  __syncthreads();
  incl += s_warp[warp];
  *total = s_warp[32];
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

// k_extract (etc/probe6.py:56): every element becomes 2 * x[7, 0], a scalar taken out of a
// computed vector, wrapping in int32 as the Pallas body's jnp product does. The rolls' shape:
// one warp a row (8 warps); every lane loads the one word x[7, 0] (one broadcast transaction a
// warp), doubles it in uint32 (defined C++ with the same bits; a signed int32 product that
// overflows is not) and stores it four times in one 16-byte vector. No shared memory, no
// barrier, no atomics. Bound on the H100: a launch; by bytes 4100 B, the one word read and the
// tile written (0.0000012 ms at 3.35 TB/s).
__global__ void __launch_bounds__(ROWS * 32) p6_extract_kernel(const int32_t* __restrict__ x,
                                                               uint4* __restrict__ o) {
  const uint32_t v = (uint32_t)__ldg(x + 7 * LANES) * 2u;
  o[threadIdx.x] = make_uint4(v, v, v, v);
}

// k_bid (etc/probe6.py:65): every row becomes its last lane, out[r, c] = x[r, 127]. The rolls'
// shape: one warp a row (8 warps); every lane of warp r loads the one word x[r, 127] (one
// broadcast transaction a warp) and stores it four times in one 16-byte vector. No shared
// memory, no barrier. Bound on the H100: a launch; by bytes 4128 B, the 8 last lanes read
// and the tile written (0.0000012 ms).
__global__ void __launch_bounds__(ROWS * 32) p6_bid_kernel(const int32_t* __restrict__ x,
                                                           int4* __restrict__ o) {
  const int32_t v = __ldg(x + (threadIdx.x >> 5) * LANES + LANES - 1);
  o[threadIdx.x] = make_int4(v, v, v, v);
}

// k_dot3 (etc/probe6.py:74): out[r, j] = the number of lanes l of row r with x[r, l] mod 384
// == j, for j < 128 (the one-hot [8, 384, 128] x ones product, plane 0, columns 0..127). One
// warp a row (8 warps): lane l loads elements 4l .. 4l + 3 of its row in one 16-byte vector
// and takes each one's floor mod 384 (in [0, 384), as jnp's %; -2^31 gives 256). The warp
// keeps the row's 128 counters, bins 0..127 only, in 512 bytes of shared memory of its own,
// zeroed by one 16-byte store a lane; each lane adds its elements that fall below 128 with
// four shared atomicAdds, and lane l then stores counters 4l .. 4l + 3 in one 16-byte vector.
// A __syncwarp orders the zeroing before the adds and the adds before the stores: no CTA
// barrier, no zeroing of bins that are never read. Rounds of __match_any_sync with one plain
// add a bin, in place of the atomics, took 0.00225 ms on the probe's arange tile against
// 0.00116 (an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py --turns): a match of 32 distinct
// bins costs more than the atomics it saves, and a row of one bin cost the atomics no more.
// Bound on the H100: a launch and four dependent shared steps; by bytes 8 KiB (0.0000024 ms).
__global__ void __launch_bounds__(ROWS * 32) p6_dot3_kernel(const int4* __restrict__ x,
                                                            int4* __restrict__ o) {
  __shared__ int4 bins[ROWS][32];  // warp r's 128 counters
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int4 v = x[threadIdx.x];
  bins[r][lane] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int* count = reinterpret_cast<int*>(bins[r]);
  const int m[4] = {floor_mod(v.x, WIN), floor_mod(v.y, WIN), floor_mod(v.z, WIN), floor_mod(v.w, WIN)};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (m[k] < LANES) atomicAdd(count + m[k], 1);
  __syncwarp();
  o[threadIdx.x] = bins[r][lane];
}

// k_rmw (etc/probe6.py:92): a zeroed row of n words with words [a, a + 384) XORed with 7,
// a = (i >> 7) * 128. The Pallas body zeroed the row in VMEM, then read and rewrote the window
// at an offset it took from SMEM. Here nothing is read back: word j is 7 where
// (unsigned)(j - a) < 384 and 0 elsewhere, computed once and stored once. Each thread owns 4
// consecutive words (one 16-byte group; a scalar head and tail where the row is off a 16-byte
// bound or n is not a multiple of 4), as p8_d_kernel's threads do, on a grid of P6R_THREADS-
// thread CTAs sized from n by the launcher (3 CTAs at n = 1152), so that the stores spread
// over a few SMs, one 16-byte store a thread. The load of i comes first: lane 0 of each warp
// loads it before anything else and a shuffle broadcasts it, one load a warp. a is taken by
// an arithmetic shift of the signed int32, so a negative i gives a negative a and a bad
// window; (i >> 7) * 128 fits int32 for every i (2^31 - 128 at most), a + 384 need not, so the
// window is checked as a <= n - 384. A bad window stores nothing but the mapped flag word (one
// plain store; the wrapper raises IndexError). No zeroing pass, barrier, shared memory or
// atomics. Bound on the H100: a launch and one dependent load; by bytes 4 B in and 4n B out
// (0.0000014 ms at n = 1152).
constexpr int P6R_THREADS = 128;

__global__ void __launch_bounds__(P6R_THREADS)
p6_rmw_kernel(const int32_t* __restrict__ i, uint32_t* __restrict__ o, int n, int32_t* err) {
  const int lane = threadIdx.x & 31;
  int iv = 0;
  if (lane == 0) iv = __ldg(i);
  // group q holds the words j0 = 4q - off .. j0 + 3, 16-byte aligned
  const int off = (int)(((uintptr_t)o >> 2) & 3);
  const int j0 = 4 * (int)(blockIdx.x * P6R_THREADS + threadIdx.x) - off;
  const int a = (__shfl_sync(FULL, iv, 0) >> 7) * LANES;
  if (a < 0 || a > n - WIN) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *reinterpret_cast<volatile int32_t*>(err) = 1;
    return;
  }
  uint32_t x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = (uint32_t)(j0 + k - a) < (uint32_t)WIN ? 7u : 0u;
  if (j0 >= 0 && j0 + 4 <= n) {
    *reinterpret_cast<uint4*>(o + j0) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j0 + k >= 0 && j0 + k < n) o[j0 + k] = x[k];
  }
}

// k_shift (etc/probe6.py:111): (v << s) | (v >> (31 - s)) on the u32 pattern v of each
// element, s = x mod 31 as a floor mod (in [0, 30], as jnp's % on a negative int32). It is not
// a rotation: a rotate (__funnelshift_l) shifts right by 32 - s, this by 31 - s, and at s = 0
// it ORs in v >> 31. The rolls' shape: one warp a row (8 warps), lane l loads the row's
// 16-byte vector l, computes its four elements in registers and stores one 16-byte vector.
// No shared memory, no barrier. Bound on the H100: a launch; by bytes 8 KiB (0.0000024 ms).
__device__ __forceinline__ int32_t shift31(int32_t x) {
  const uint32_t v = (uint32_t)x, s = (uint32_t)floor_mod(x, 31);
  return (int32_t)((v << s) | (v >> (31u - s)));
}

__global__ void __launch_bounds__(ROWS * 32) p6_shift_kernel(const int4* __restrict__ x,
                                                             int4* __restrict__ o) {
  const int4 v = x[threadIdx.x];
  o[threadIdx.x] = make_int4(shift31(v.x), shift31(v.y), shift31(v.z), shift31(v.w));
}

// ---- etc/probe7.py: the pack kernel, built up in five levels -----------------
//
// One CTA per (row, tile of 1024 tokens): every tile of every row at once,
// where the script's grid walked a row's tiles in order with the bit offset
// carried from one to the next.
//   level 1  the tile's start offset c0 and the scan of its widths; total bits
//   level 2  + masked value split into the part for word off >> 5 (hi) and
//            the spill into the next word (lo)
//   level 3  + XOR scan of hi segmented by target word (over a warp); the
//            last token of each run keeps the run's word part
//   level 4  + scatter of the parts into a window in shared memory that
//            starts at the tile's 128-aligned base word
//   level 5  + the window's words written into the arena
// c0, the widths of the row's tiles before this one, the CTA sums itself
// (16-byte loads where the widths are 16-byte aligned), in the same CTA scan
// as its own widths: each thread's share of the earlier widths rides in the
// high half of a 64-bit scan value, its own width in the low half. That
// reads t x 4 KiB more for tile t, all in flight with the tile's own loads,
// and waits on no other CTA; a decoupled look-back over the tile totals
// would add a chain of round trips between CTAs and a zeroed status array
// per launch. At the probe's 3 tiles a row that is at most 2048 widths; the
// re-sum is exact for any row, but its reads grow as T(T - 1)/2 tiles of
// widths over a row of T tiles, so the wrapper takes at most 16 tiles a row
// (probes.P7_MAX_TILES).
// Every word of the arena is written once, with a plain store, and nothing
// zeroes it first. Levels 1-4 write zeros, each CTA its share of the row.
// At level 5 a word that a tile boundary cuts (c0 not a multiple of 32)
// belongs to the last tile that starts inside it: that tile ORs its own
// bits of the word with the earlier tokens' (warp 0 walks back over them,
// 32 tokens at a time, the first 32 loaded at the start), and the tiles
// before it leave the word alone; every other word with bits lies in one
// tile; the last tile zeroes the words past the row's bits. (A memset of
// the arena before the kernel, and atomicXor on the shared words, cost a
// launch's host time more: 12.8 against 5.1 us a launch on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py phase 9.) Only level 5 writes bits
// into the arena, as in the script; `mid`, when given, takes what levels
// 2-4 computed: [B, NT, 2] (hi, lo) at level 2, the same with the run parts
// at level 3, [B, tiles, TILE_WIN] windows at level 4. Bad widths (outside
// [0, 32]) set the flag and count as 0, in the re-sums too.
__device__ __forceinline__ int width_or_0(int w) { return (w < 0 || w > 32) ? 0 : w; }

// The parts of a token of width nb (0-32) at bit offset off: hi for word
// off >> 5, lo for the word after.
__device__ __forceinline__ void token_parts(uint32_t v, int nb, int off, uint32_t* hi, uint32_t* lo) {
  const uint32_t vm = v & (nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u));
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

// grid (B, tiles); dynamic shared memory: TILE_WIN words at level >= 4.
__global__ void __launch_bounds__(TILE)
p7_pack_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ nbits, int64_t nt,
               int n_wp, uint32_t* words, int32_t* bits, int level, uint32_t* mid, int32_t* err,
               int vec) {
  __shared__ unsigned long long s_scan[33];
  extern __shared__ uint32_t win[];
  const int64_t b = blockIdx.x;
  const int t = blockIdx.y, n_tiles = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int32_t* nb_row = nbits + b * nt;
  const uint32_t* v_row = vals + b * nt;
  uint32_t* arena = words + b * n_wp;
  const int64_t i = (int64_t)t * TILE + tid;
  int nb = __ldg(nb_row + i);
  const uint32_t v = __ldg(v_row + i);
  if (nb < 0 || nb > 32) {
    *reinterpret_cast<volatile int32_t*>(err) = 1;
    nb = 0;
  }
  int back_nb = 0;  // warp 0 at level 5: the 32 tokens before the tile
  uint32_t back_v = 0;
  if (level == 5 && t > 0 && tid < 32) {
    back_nb = width_or_0(__ldg(nb_row + i - 32));
    back_v = __ldg(v_row + i - 32);
  }
  if (level < 5) {  // the arena stays zero: this CTA's share of the row
    const int lo = (int)((int64_t)n_wp * t / n_tiles), hi = (int)((int64_t)n_wp * (t + 1) / n_tiles);
    for (int w = lo + tid; w < hi; w += TILE) arena[w] = 0;
  }
  int before = 0;  // this thread's share of the widths of tiles 0 .. t - 1
  if (vec) {
    const int4* q4 = reinterpret_cast<const int4*>(nb_row);
    for (int j = tid; j < t * (TILE / 4); j += TILE) {
      const int4 q = __ldg(q4 + j);
      before += width_or_0(q.x) + width_or_0(q.y) + width_or_0(q.z) + width_or_0(q.w);
    }
  } else {
    for (int64_t j = tid; j < (int64_t)t * TILE; j += TILE) before += width_or_0(__ldg(nb_row + j));
  }
  unsigned long long sum;
  const unsigned long long incl =
      tile_inclusive_scan(((unsigned long long)before << 32) | (unsigned)nb, s_scan, &sum);
  const int c0 = (int)(sum >> 32), tile_bits = (int)(uint32_t)sum;  // a tile's bits < 2^32
  const int off = c0 + (int)(uint32_t)incl - nb;
  if (t == n_tiles - 1 && tid == 0) bits[b] = c0 + tile_bits;
  if (level == 1) return;

  uint32_t hi, lo;
  token_parts(v, nb, off, &hi, &lo);
  const int w0 = off >> 5;
  if (level == 2) {
    if (mid != nullptr) reinterpret_cast<uint2*>(mid)[b * nt + i] = make_uint2(hi, lo);
    return;
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
    if (mid != nullptr) reinterpret_cast<uint2*>(mid)[b * nt + i] = make_uint2(hi_c, lo_c);
    return;
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
    return;
  }

  const int end = c0 + tile_bits;
  const bool last = t == n_tiles - 1;
  const int w_first = c0 >> 5;
  // the words this tile writes: from its first word (when a boundary cuts
  // it, only as the last tile starting inside it) up to its last word that
  // no later tile starts inside (the last tile: all of its words)
  const int w_last = last ? ((end + 31) >> 5) - 1 : (end >> 5) - 1;
  uint32_t earlier = 0;  // the bits of word w_first that tokens before the tile hold
  if (tid < 32 && (c0 & 31) && w_first <= w_last) {
    const int need = c0 & 31;  // bits of the word below c0
    int64_t k = (int64_t)t * TILE;  // tokens [k - 32, k) at a time, back from the tile
    int after = 0;  // the widths of tokens k .. t * TILE - 1
    for (;;) {
      int suffix = back_nb;  // widths of this lane's token and those after it in the chunk
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(FULL, suffix, d);
        if (lane + d < 32) suffix += y;
      }
      const int tok_end = c0 - after - (suffix - back_nb);
      uint32_t part = 0;
      if (back_nb > 0 && tok_end > 32 * w_first) {
        uint32_t phi, plo;
        token_parts(back_v, back_nb, tok_end - back_nb, &phi, &plo);
        const int tw = (tok_end - back_nb) >> 5;
        part = (tw == w_first ? phi : 0u) | (tw + 1 == w_first ? plo : 0u);
      }
      earlier |= __reduce_or_sync(FULL, part);
      after += __shfl_sync(FULL, suffix, 0);
      k -= 32;
      if (after >= need || k == 0) break;
      back_nb = width_or_0(__ldg(nb_row + k - 32 + lane));
      back_v = __ldg(v_row + k - 32 + lane);
    }
  }
  for (int w = w_first + tid; w <= w_last && w < n_wp; w += TILE)
    arena[w] = win[w - abase] | (w == w_first ? earlier : 0u);
  if (last)  // the words past the row's bits
    for (int w = ((end + 31) >> 5) + tid; w < n_wp; w += TILE) arena[w] = 0;
}

// ---- etc/probe8.py: the pack kernel's infrastructure, in four steps ----------
//
// v [B, T, 8, 128] int32; words [B, n_wp] (every word written here, as the
// scripts' first grid step zeroed them); carry [B] is the scalar the scripts
// carried and never stored, given out so that it can be checked.

// row[lo .. n) = 0, each word once, by threads tid of nthreads: 16-byte stores
// between the 16-byte bounds, scalar words before the first and after the last.
__device__ __forceinline__ void zero_words(uint32_t* row, int lo, int n, int tid, int nthreads) {
  if (lo >= n) return;
  const int head = min(n, lo + (int)((4 - (((uintptr_t)(row + lo) >> 2) & 3)) & 3));
  const int nvec = (n - head) >> 2;
  if (tid < head - lo) row[lo + tid] = 0;
  uint4* vec = reinterpret_cast<uint4*>(row + head);
  for (int i = tid; i < nvec; i += nthreads) vec[i] = make_uint4(0, 0, 0, 0);
  if (tid < n - head - 4 * nvec) row[head + 4 * nvec + tid] = 0;
}

// 4 consecutive ints of v from p, as one 16-byte load where `vec` says p's row is on a bound
__device__ __forceinline__ uint4 load4(const int32_t* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  return make_uint4((uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]);
}

constexpr int P8_ZERO_WORDS = 2048;  // zeros a zeroing CTA of k_b and k_c stores

// a: the arena zeroed, the carry the sum of v[b, t, 0, 0] over the tiles. The Pallas
// body revisited the arena every grid step and added one scalar a tile. Here the grid is
// (B, word groups) of P8A_THREADS-thread CTAs, each storing its P8A_ZERO_WORDS words of
// the row in 16-byte stores (zero_words), each word once; warp 0 of CTA (b, 0) also takes
// the carry: lane l loads the first word of tiles l, l + 32, ... (its first load issued
// before the CTA's stores, so that they overlap), adds in u32 (JAX's wrapped int32 adds)
// and __reduce_add_sync gives the sum, which lane 0 stores. No atomics, memset or flag.
// Bound on the H100: a launch and one dependent load.
constexpr int P8A_THREADS = 128;
constexpr int P8A_ZERO_WORDS = 4 * P8A_THREADS;  // one 16-byte store a thread

__global__ void __launch_bounds__(P8A_THREADS)
p8_a_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool carry = blockIdx.y == 0 && tid < 32;
  uint32_t sum = carry && tid < T ? (uint32_t)v[(b * T + tid) * TILE] : 0u;
  const int lo = (int)blockIdx.y * P8A_ZERO_WORDS;
  zero_words(words + b * n_wp, lo, min(n_wp, lo + P8A_ZERO_WORDS), tid, P8A_THREADS);
  if (!carry) return;
  for (int t = tid + 32; t < T; t += 32) sum += (uint32_t)v[(b * T + t) * TILE];
  sum = __reduce_add_sync(FULL, sum);
  if (tid == 0) carry_out[b] = (int32_t)sum;
}

// b: the arena zeroed, the carry the sum of every tile's total, that is of all of v[b].
// The Pallas body scanned each tile's lanes and rows with rolls to reach its total, of
// which it kept only the last. Here it is one reduction, not a scan, on k_c's grid
// (B, 1 + zeroing CTAs): CTA (b, 0) reads v[b] once, 4 ints a thread a step (16-byte
// loads through load4; scalar where v is off a 16-byte bound), each lane adds in u32,
// each warp reduces with __reduce_add_sync, and the warps' sums meet in shared memory
// across one barrier; thread 0 stores the carry. The launch sizes that CTA to v[b]'s
// 16-byte groups (32 to 1024 threads), so at the probe's 3 tiles each thread issues one
// load. CTAs (b, y > 0) store the zeros, P8_ZERO_WORDS each. A row stays on one CTA:
// splitting it would need atomics or a second pass. No atomics, memset or flag. Bound on
// the H100: a launch and one SM's read of v[b] (12 KiB at the probe's shape).
constexpr int P8B_MAX_THREADS = 1024;

__global__ void __launch_bounds__(P8B_MAX_THREADS)
p8_b_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  __shared__ uint32_t s_warp[P8B_MAX_THREADS / 32];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.y > 0) {
    const int lo = (int)(blockIdx.y - 1) * P8_ZERO_WORDS;
    zero_words(words + b * n_wp, lo, min(n_wp, lo + P8_ZERO_WORDS), tid, blockDim.x);
    return;
  }
  const int32_t* vb = v + b * T * TILE;
  const bool vec = ((uintptr_t)v & 15) == 0;  // every row of v then starts on a 16-byte bound
  const int64_t n4 = (int64_t)T * (TILE / 4);
  uint32_t sum = 0;
#pragma unroll 4
  for (int64_t i = tid; i < n4; i += blockDim.x) {
    const uint4 r = load4(vb + 4 * i, vec);
    sum += r.x + r.y + r.z + r.w;
  }
  sum = __reduce_add_sync(FULL, sum);
  if (lane == 0) s_warp[warp] = sum;
  __syncthreads();
  if (warp > 0) return;
  sum = __reduce_add_sync(FULL, lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0u);
  if (lane == 0) carry_out[b] = (int32_t)sum;
}

// c: words[0 .. k) = c0 + the lane scan of row 0 of the last tile, k = min(128, n_wp),
// c0 the sum of row 7 over the tiles before the last; the other words 0; the carry row
// 7's sum over every tile. The Pallas body walked the tiles in order, scanned all 8 rows
// of each and rewrote words[0 .. 128) each step. Only row 7 of every tile and row 0 of
// the last one carry the result, and each tile's row-7 sum stands alone, so CTA (b, 0)
// reads T x 128 + 128 ints, not T x 1024: warp w < R (R = min(T, 31), blockDim 32 (R + 1))
// reduces row 7 of tiles w, w + R, ... (4 ints a lane, __reduce_add_sync), and warp R
// scans row 0 of the last tile (4 ints a lane, then the lanes' sums by shuffles). The
// sums meet in shared memory across one barrier, and warp R stores words[0 .. k) and the
// carry. CTAs (b, 1 ..) store the zeros, P8_ZERO_WORDS each, in 16-byte stores: issued
// by the scanning CTA, they delay its loads. Every word is stored once. Sums are u32,
// JAX's wrapped int32 adds. Bound on the H100: a launch, one load and one barrier.
constexpr int P8C_MAX_WARPS = 32;

__global__ void __launch_bounds__(P8C_MAX_WARPS * 32)
p8_c_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  __shared__ uint32_t s_before[P8C_MAX_WARPS];  // warp w's row-7 sums of its tiles before the last
  __shared__ uint32_t s_last;                   // row 7's sum of the last tile
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, R = (blockDim.x >> 5) - 1;
  uint32_t* row = words + b * n_wp;
  const int k = T > 0 ? min(LANES, n_wp) : 0;
  if (blockIdx.y > 0) {
    const int lo = k + (int)(blockIdx.y - 1) * P8_ZERO_WORDS;
    zero_words(row, lo, min(n_wp, lo + P8_ZERO_WORDS), tid, blockDim.x);
    return;
  }
  if (T == 0) {  // no tile: the Pallas grid never ran
    if (tid == 0) carry_out[b] = 0;
    return;
  }
  const int32_t* vb = v + b * T * TILE;
  const bool vec = ((uintptr_t)v & 15) == 0;  // every row of v then starts on a 16-byte bound
  uint4 x = make_uint4(0, 0, 0, 0);
  if (warp < R) {
    uint32_t before = 0;
    for (int t = warp; t < T; t += R) {
      const uint4 r = load4(vb + (int64_t)t * TILE + 7 * LANES + 4 * lane, vec);
      const uint32_t sum = __reduce_add_sync(FULL, r.x + r.y + r.z + r.w);
      if (t < T - 1) before += sum;
      else if (lane == 0) s_last = sum;
    }
    if (lane == 0) s_before[warp] = before;
  } else {
    x = load4(vb + (int64_t)(T - 1) * TILE + 4 * lane, vec);
    x.y += x.x;
    x.z += x.y;
    x.w += x.z;
    const uint32_t ex = warp_inclusive_scan(x.w) - x.w;
    x.x += ex;
    x.y += ex;
    x.z += ex;
    x.w += ex;
  }
  __syncthreads();
  if (warp < R) return;
  const uint32_t c0 = __reduce_add_sync(FULL, lane < R ? s_before[lane] : 0u);
  x.x += c0;
  x.y += c0;
  x.z += c0;
  x.w += c0;
  if (k == LANES && (((uintptr_t)row & 15) == 0)) {
    reinterpret_cast<uint4*>(row)[lane] = x;
  } else {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * lane + i < k) row[4 * lane + i] = xs[i];
  }
  if (lane == 0) carry_out[b] = (int32_t)(c0 + s_last);
}

// d: eight windowed XOR read-modify-writes a tile: words[a .. a + 384) ^= g + 1 for
// every tile t and row g, a = (base >> 7) * 128 with base = (v[t, g, 0] * 3) mod 8, over
// a zeroed arena. The windows of one row overlap, so the old design zeroed the arena,
// then XORed with atomics (24 a word at the probe's shape, serialised in L2). Here each
// word's value is the XOR of the values of the windows that cover it, and each thread
// owns 4 consecutive words (one 16-byte group; a scalar head and tail where the row is
// off a bound), folds the windows into them in registers and stores each word once.
// Each warp stages 32 windows at a time, a lane each (one read of v), and broadcasts
// their starts by shuffles: no shared memory and no barrier. A window covers whole
// 128-word blocks (a and 384 are multiples of 128), so two compares a window, for the
// group's first and last word, settle all four. No memset, no atomics, no flag: base < 8,
// so a is 0 for every v and the wrapper checks n_wp >= 384 before the launch; the kernel
// still computes a. v * 3 is taken in u32: (v * 3) mod 8 of the wrapped int32 product, as
// JAX has it. Grid (B, word groups / P8D_THREADS): small CTAs spread the folding over
// more SMs. Bound on the H100: a launch and one load.
constexpr int P8D_THREADS = 128;

__global__ void __launch_bounds__(P8D_THREADS)
p8_d_kernel(const int32_t* v, int T, int n_wp, uint32_t* words, int32_t* carry_out) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t* row = words + b * n_wp;
  // group q holds the words j = 4q - off .. 4q - off + 3, 16-byte aligned
  const int off = (int)(((uintptr_t)row >> 2) & 3);
  const int j0 = 4 * (int)(blockIdx.y * P8D_THREADS + tid) - off;
  const int nw = T * ROWS;  // windows: w = t * 8 + g
  uint32_t x0 = 0, x3 = 0;  // words j0 and j0 + 3
  for (int c = 0; c < nw; c += 32) {
    int a_lane = 0;  // the start of window c + lane
    if (c + lane < nw) {
      const int w = c + lane;
      const uint32_t base = ((uint32_t)v[(b * T + (w >> 3)) * TILE + (w & 7) * LANES] * 3u) & 7u;
      a_lane = (int)(base >> 7) * LANES;
    }
    const int n = min(32, nw - c);  // a multiple of 8: window c + i + g is row g
    for (int i = 0; i < n; i += ROWS) {
#pragma unroll
      for (int g = 0; g < ROWS; ++g) {
        const int a = __shfl_sync(FULL, a_lane, i + g);
        x0 ^= (uint32_t)(j0 - a) < (uint32_t)WIN ? g + 1u : 0u;
        x3 ^= (uint32_t)(j0 + 3 - a) < (uint32_t)WIN ? g + 1u : 0u;
      }
    }
  }
  const uint32_t x1 = ((j0 + 1) >> 7) == (j0 >> 7) ? x0 : x3;
  const uint32_t x2 = ((j0 + 2) >> 7) == (j0 >> 7) ? x0 : x3;
  if (blockIdx.y == 0 && tid == 0) carry_out[b] = 0;
  if (j0 >= n_wp) return;
  if (j0 >= 0 && j0 + 4 <= n_wp) {
    *reinterpret_cast<uint4*>(row + j0) = make_uint4(x0, x1, x2, x3);
  } else {
    const uint32_t xs[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j0 + i >= 0 && j0 + i < n_wp) row[j0 + i] = xs[i];
  }
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

// x, o: one [8, 128] int32 tile each (16-byte aligned, but for k_extract's and k_bid's x).
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
  if ((uintptr_t)o & 15) return (int)cudaErrorMisalignedAddress;  // x is read a word at a time
  p6_extract_kernel<<<1, ROWS * 32, 0, STREAM>>>(I32(x), static_cast<uint4*>(o));
  return last_error();
}
extern "C" int tdc_probe6_bid(const void* x, void* o, void* stream) {
  if ((uintptr_t)o & 15) return (int)cudaErrorMisalignedAddress;  // x is read a word at a time
  p6_bid_kernel<<<1, ROWS * 32, 0, STREAM>>>(I32(x), static_cast<int4*>(o));
  return last_error();
}
extern "C" int tdc_probe6_dot3(const void* x, void* o, void* stream) {
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorMisalignedAddress;
  p6_dot3_kernel<<<1, ROWS * 32, 0, STREAM>>>(static_cast<const int4*>(x), static_cast<int4*>(o));
  return last_error();
}
// i [1] int32 on the device, o [n] u32 (4-byte aligned), err the mapped flag word. A CTA
// of P6R_THREADS threads a P6R_THREADS x 4 words; no launch for n <= 0.
extern "C" int tdc_probe6_rmw(const void* i, void* o, int n, void* err, void* stream) {
  if (n <= 0) return 0;
  const long long off = ((uintptr_t)o >> 2) & 3;  // words before the row's first 16-byte bound
  const long long groups = (off + n + 3) / 4;
  p6_rmw_kernel<<<(unsigned)((groups + P6R_THREADS - 1) / P6R_THREADS), P6R_THREADS, 0, STREAM>>>(
      I32(i), U32W(o), n, I32W(err));
  return last_error();
}
extern "C" int tdc_probe6_shift(const void* x, void* o, void* stream) {
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorMisalignedAddress;
  p6_shift_kernel<<<1, ROWS * 32, 0, STREAM>>>(static_cast<const int4*>(x), static_cast<int4*>(o));
  return last_error();
}

// vals, nbits [B, nt] (nt a multiple of TILE, nt * 32 < 2^31); words [B, n_wp]; bits
// [B]; mid may be null; err the mapped flag word.
extern "C" int tdc_probe7_pack(const void* vals, const void* nbits, int B, long long nt, int n_wp,
                               void* words, void* bits, int level, void* mid, void* err,
                               void* stream) {
  if (B <= 0) return 0;
  if (nt == 0) {  // no tile: an empty arena, no bits
    cudaError_t rc = cudaMemsetAsync(words, 0, (size_t)B * n_wp * sizeof(uint32_t), STREAM);
    if (rc == cudaSuccess) rc = cudaMemsetAsync(bits, 0, (size_t)B * sizeof(int32_t), STREAM);
    return (int)rc;
  }
  const dim3 grid((unsigned)B, (unsigned)(nt / TILE));
  const int vec = ((uintptr_t)nbits & 15) == 0;
  p7_pack_kernel<<<grid, TILE, level >= 4 ? TILE_WIN * sizeof(uint32_t) : 0, STREAM>>>(
      static_cast<const uint32_t*>(vals), I32(nbits), nt, n_wp, U32W(words), I32W(bits), level,
      U32W(mid), I32W(err), vec);
  return last_error();
}

// v [B, T, 8, 128] int32; words [B, n_wp]; carry [B].
// Each returns 0 with no launch when B <= 0 (the wrappers launch nothing there).
extern "C" int tdc_probe8_a(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  if (B <= 0) return 0;
  const long long gy = n_wp > 0 ? ((long long)n_wp + P8A_ZERO_WORDS - 1) / P8A_ZERO_WORDS : 1;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  p8_a_kernel<<<dim3((unsigned)B, (unsigned)gy), P8A_THREADS, 0, STREAM>>>(I32(v), T, n_wp, U32W(words),
                                                                            I32W(carry));
  return last_error();
}
extern "C" int tdc_probe8_b(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  if (B <= 0) return 0;
  const long long n4 = (long long)T * (TILE / 4);  // 16-byte groups of v[b]
  const int threads = n4 >= P8B_MAX_THREADS ? P8B_MAX_THREADS : n4 > 32 ? (int)((n4 + 31) / 32 * 32) : 32;
  const long long gy = 1 + ((long long)n_wp + P8_ZERO_WORDS - 1) / P8_ZERO_WORDS;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  p8_b_kernel<<<dim3((unsigned)B, (unsigned)gy), threads, 0, STREAM>>>(I32(v), T, n_wp, U32W(words),
                                                                       I32W(carry));
  return last_error();
}
extern "C" int tdc_probe8_c(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  if (B <= 0) return 0;
  const int R = T < P8C_MAX_WARPS - 1 ? T : P8C_MAX_WARPS - 1;  // warps reducing row 7
  const int k = T > 0 ? (n_wp < LANES ? n_wp : LANES) : 0;
  const long long gy = 1 + ((long long)n_wp - k + P8_ZERO_WORDS - 1) / P8_ZERO_WORDS;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  p8_c_kernel<<<dim3((unsigned)B, (unsigned)gy), 32 * (R + 1), 0, STREAM>>>(I32(v), T, n_wp, U32W(words),
                                                                            I32W(carry));
  return last_error();
}
// d: the wrapper has checked n_wp >= 384 (every window fits).
extern "C" int tdc_probe8_d(const void* v, int B, int T, int n_wp, void* words, void* carry,
                            void* stream) {
  if (B <= 0) return 0;
  const long long groups = ((long long)n_wp + 6) / 4;  // ceil((n_wp + 3) / 4): a row may start 3 words off a bound
  const long long gy = (groups + P8D_THREADS - 1) / P8D_THREADS;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  p8_d_kernel<<<dim3((unsigned)B, (unsigned)gy), P8D_THREADS, 0, STREAM>>>(I32(v), T, n_wp, U32W(words),
                                                                            I32W(carry));
  return last_error();
}
