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
// holding element (r, c).
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
//   - The VMEM gather is an indexed load.
// Bound on the H100: the gather by the bytes it moves (idx read, out
// written, S read at most once); every other kernel works on a few KiB and
// is bound by its launch and a handful of dependent shared-memory steps.
// Words are u32 bit patterns; the wrappers hand them over in int32 tensors.

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

__global__ void gather_kernel(const uint32_t* __restrict__ S, const int32_t* __restrict__ idx,
                              uint32_t* __restrict__ out, int64_t ns, int64_t ni, int32_t* err) {
  const int64_t b = blockIdx.y;
  const uint32_t* s = S + b * ns;
  const int32_t* ix = idx + b * ni;
  uint32_t* o = out + b * ni;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < ni;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = ix[i];
    if (j < 0 || j >= ns) {
      atomicOr(err, 1);
      o[i] = 0;
    } else {
      o[i] = s[j];
    }
  }
}

// ---- etc/probe6.py: seven primitives on one [8, 128] int32 tile -------------

__global__ void __launch_bounds__(TILE) p6_roll_lane_kernel(const int32_t* x, int32_t* o) {
  __shared__ int32_t t[TILE];
  const int tid = threadIdx.x, r = tid >> 7, c = tid & 127;
  t[tid] = x[tid];
  __syncthreads();
  o[tid] = t[r * LANES + ((c + LANES - 1) & (LANES - 1))];
}

__global__ void __launch_bounds__(TILE) p6_roll_sublane_kernel(const int32_t* x, int32_t* o) {
  __shared__ int32_t t[TILE];
  const int tid = threadIdx.x, r = tid >> 7, c = tid & 127;
  t[tid] = x[tid];
  __syncthreads();
  o[tid] = t[((r + ROWS - 1) & (ROWS - 1)) * LANES + c];
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
    if (tid == 0) atomicOr(err, 1);
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
        atomicOr(err, 1);
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
      if (c == 0) atomicOr(err, 1);
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

// S [B, ns] u32, idx [B, ni] i32 -> out [B, ni] u32; err [1] is set when an
// index lies outside [0, ns).
extern "C" int tdc_probe3_gather(const void* S, const void* idx, void* out, int B, long long ns,
                                 long long ni, void* err, void* stream) {
  const int threads = 256;
  long long gx = (ni + threads * 4 - 1) / (threads * 4);
  if (gx < 1) gx = 1;
  if (gx > 65535) gx = 65535;
  dim3 grid((unsigned)gx, (unsigned)B);
  gather_kernel<<<grid, threads, 0, STREAM>>>(static_cast<const uint32_t*>(S), I32(idx),
                                              U32W(out), ns, ni, I32W(err));
  return last_error();
}

// x, o: one [8, 128] int32 tile each.
extern "C" int tdc_probe6_roll_lane(const void* x, void* o, void* stream) {
  p6_roll_lane_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}
extern "C" int tdc_probe6_roll_sublane(const void* x, void* o, void* stream) {
  p6_roll_sublane_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
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
// i [1] int32 on the device, o [n] u32, err [1].
extern "C" int tdc_probe6_rmw(const void* i, void* o, int n, void* err, void* stream) {
  p6_rmw_kernel<<<1, TILE, 0, STREAM>>>(I32(i), U32W(o), n, I32W(err));
  return last_error();
}
extern "C" int tdc_probe6_shift(const void* x, void* o, void* stream) {
  p6_shift_kernel<<<1, TILE, 0, STREAM>>>(I32(x), I32W(o));
  return last_error();
}

// vals, nbits [B, nt]; words [B, n_wp]; bits [B]; mid may be null; err [1].
extern "C" int tdc_probe7_pack(const void* vals, const void* nbits, int B, long long nt, int n_wp,
                               void* words, void* bits, int level, void* mid, void* err,
                               void* stream) {
  p7_pack_kernel<<<B, TILE, 0, STREAM>>>(static_cast<const uint32_t*>(vals), I32(nbits), nt, n_wp,
                                         U32W(words), I32W(bits), level, U32W(mid), I32W(err));
  return last_error();
}

// v [B, T, 8, 128] int32; words [B, n_wp]; carry [B]; err [1] (d only).
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
