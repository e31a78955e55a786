// Kernel I (esp_adjust_windows): the adjust pass of one ESP round, the
// reference's 3-slot queue machine over each span of blocks, a lane a span,
// the spans a warp owns staged in shared memory.
//
// What it replaces: tudocomp_tpu/ops/esp_jax.py:87 (_sim_window under
// _adjust_dev) is plain JAX, no Pallas kernel: the queue machine of
// compressors/esp.py:_adjust_blocks (BlockAdjust.hpp:38-131) as a
// while_loop vmapped over spans by _tier_sim (:206-220), with lane caps (OC,
// CAP2, a widest span of 128 blocks) past which the round falls back to the
// host. In PyTorch that loop is ~30 small launches and a host sync a step,
// hundreds of steps a round (ops/esp_kernels.py:esp_adjust_windows_plain,
// the plain version). The machine here takes a span of any width, so the
// caps and their fallback are gone.
//
// The queue only ever changes blocks near a block of length 1: away from one
// it pops each block as it was filled. So the caller (ops/esp_torch.py:
// adjust_spans) cuts the round's blocks into spans, the unions of the
// [i - 3, i + 4) windows around the length-1 blocks i, as _adjust_dev
// builds them (heads at least 7 blocks apart, so spans never overlap, in
// increasing order), and passes each span's [ws, we) with the span count
// ns, which stays in device memory: the launch needs no host sync.
//
// A lane runs the machine over its span's (len, type) pairs: fill (slot qn
// gets the next block) while the queue holds fewer than 3 and blocks
// remain, else merge the first pair the reference's step picks, else pop
// the front; after the first three fills a pass is a merge or a pop and the
// one fill that may follow it. A merge never adds a block, so the lane writes each popped
// block over its own span at the next output slot (which it has read
// already) and sets the lengths of the slots a merge freed to 0. The caller
// compacts the blocks with a cumsum and a scatter.
//
// What bounds it on the H100: the function reads each span's blocks once
// and writes them once (16 bytes a block) plus 8 bytes a span; spans are a
// few blocks around each length-1 block, a small share of the round (at 16
// MiB the first round's 1.66M of 7.34M blocks). What limits the kernel is
// each lane's serial chain (three steps a block, each a dependent load or a
// handful of compares), the scattered accesses of lanes whose spans lie far
// apart, and the launch. A grid sized to the static bound on spans (size
// // 7 + 1) would launch 9,363 CTAs at 16 MiB for the 826 that hold live
// spans, and a machine run out of device memory makes every fill a
// dependent load from a sector of its own. So:
//   - a persistent grid, the CTAs that fit on the card at once, strides over
//     groups of 32 consecutive spans, a warp a group, up to the count read
//     on the device;
//   - the warp stages its group: a warp scan of the span widths, then its
//     lanes copy the union of the spans' (len, type) pairs into shared
//     memory with loads that run along each span (a lane finds its pair's
//     span by a binary search over the scan, through shuffles), each lane
//     runs its span's machine there, and the warp writes the spans back
//     the same way, the freed slots' zeros with them;
//   - a span wider than SLOT blocks, or one past the warp's CAP staged
//     blocks, runs its machine on device memory in the same pass: any width
//     stays exact.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;     // a CTA's warps, a group of 32 spans each
constexpr int SLOT = 64;     // the widest span staged in shared memory
constexpr int CAP = 1024;    // blocks a warp stages: 8 KiB of (len, type)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// The queue machine over one span of n blocks at (L, T), in place. A fill
// comes first whenever the queue has room and blocks remain; no step takes
// more than one block off the queue, so after the first three fills each
// merge or pop is followed by at most one fill, done in the same pass.
__device__ __forceinline__ void adjust_span(int32_t* L, int32_t* T, const int navail) {
  int l0 = 0, l1 = 0, l2 = 0, t0 = 0, t1 = 0, t2 = 0;
  int qn = min(navail, 3), ip = qn, op = 0;
  if (qn > 0) { l0 = L[0]; t0 = T[0]; }
  if (qn > 1) { l1 = L[1]; t1 = T[1]; }
  if (qn > 2) { l2 = L[2]; t2 = T[2]; }
  while (qn > 0) {
    bool merged = false;
    const bool any1 = l0 == 1 || (qn > 1 && l1 == 1) || (qn > 2 && l2 == 1);
    if (any1) {
      if (qn == 3 && (l1 == 1 || l2 == 1) && t1 == 2 && t2 == 2) {  // merge q[1], q[2]
        const int sum = l1 + l2;
        if (sum <= 3) {  // one block of sum: the back slot goes
          l1 = sum;
          t1 = 2;
          qn = 2;
        } else {
          l1 = 2; l2 = 2; t1 = 2; t2 = 2;
        }
        merged = true;
      } else if (qn >= 2 && (l0 == 1 || l1 == 1)) {  // merge q[0], q[1]
        const int mt = (t0 == 2 && t1 == 2) ? 2 : t0 == 3 ? 3 : (t0 == 1 || t1 == 1) ? 1 : 0;
        if (mt != 0) {
          const int sum = l0 + l1;
          if (sum <= 3) {  // one block of sum: the front slot goes
            l0 = sum; t0 = mt;
            l1 = l2; t1 = t2;
            --qn;
          } else {
            l0 = 2; l1 = 2; t0 = mt; t1 = mt;
          }
          merged = true;
        }
      }
    }
    if (!merged) {  // pop the front block into the next output slot
      L[op] = l0;
      T[op] = t0;
      ++op;
      l0 = l1; t0 = t1;
      l1 = l2; t1 = t2;
      --qn;
    }
    if (qn < 3 && ip < navail) {  // fill: slot qn gets the next block
      const int bl = L[ip], bt = T[ip];
      if (qn == 0) {
        l0 = bl; t0 = bt;
      } else if (qn == 1) {
        l1 = bl; t1 = bt;
      } else {
        l2 = bl; t2 = bt;
      }
      ++qn;
      ++ip;
    }
  }
  for (int j = op; j < navail; ++j) L[j] = 0;  // slots that merges freed
}

// Copies the warp's staged pairs between device memory and shared memory:
// pair f of [0, total) lies in span k, the lane whose inclusive width scan
// `incl` first passes f, at a + f - excl of that lane. Four pairs a lane
// at a time, their loads issued together.
template <bool kToShared>
__device__ __forceinline__ void copy_staged(int32_t* __restrict__ lens, int32_t* __restrict__ typs,
                                            int32_t* sl, int32_t* st, int total, int incl, int excl, int a,
                                            int lane) {
  constexpr int BATCH = 4;
  for (int f0 = 0; f0 < total; f0 += 32 * BATCH) {
    int at[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int f = f0 + 32 * u + lane;
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(FULL, incl, k + step - 1) <= f) k += step;
      }
      at[u] = __shfl_sync(FULL, a, k) + f - __shfl_sync(FULL, excl, k);
    }
    if (kToShared) {
      int32_t l[BATCH] = {}, t[BATCH] = {};
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (f0 + 32 * u + lane < total) {
          l[u] = lens[at[u]];
          t[u] = typs[at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int f = f0 + 32 * u + lane;
        if (f < total) {
          sl[f] = l[u];
          st[f] = t[u];
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int f = f0 + 32 * u + lane;
        if (f < total) {
          lens[at[u]] = sl[f];
          typs[at[u]] = st[f];
        }
      }
    }
  }
}

// grid: the CTAs resident at once (or fewer), 32 * WARPS threads.
__global__ void __launch_bounds__(32 * WARPS)
esp_adjust_staged_kernel(int32_t* __restrict__ lens, int32_t* __restrict__ typs, const int32_t* __restrict__ ws,
                         const int32_t* __restrict__ we, const int32_t* __restrict__ ns, int max_spans) {
  __shared__ int32_t s_len[WARPS][CAP];
  __shared__ int32_t s_typ[WARPS][CAP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = min(*ns, max_spans);
  int32_t* sl = s_len[warp];
  int32_t* st = s_typ[warp];
  const int64_t step = (int64_t)gridDim.x * WARPS * 32;
  for (int64_t g = ((int64_t)blockIdx.x * WARPS + warp) * 32; g < live; g += step) {
    const int s = (int)g + lane;
    int a = 0, width = 0;
    if (s < live) {
      a = ws[s];
      width = we[s] - a;
    }
    const int narrow = width <= SLOT ? width : 0;
    int incl = narrow;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const bool staged = narrow > 0 && incl <= CAP;
    const int excl = incl - narrow;
    const int total = __reduce_max_sync(FULL, staged ? incl : 0);
    copy_staged<true>(lens, typs, sl, st, total, incl, excl, a, lane);
    __syncwarp();
    if (staged) {
      adjust_span(sl + excl, st + excl, width);
    } else if (width > 0) {  // too wide for the slot, or past the warp's CAP
      adjust_span(lens + a, typs + a, width);
    }
    __syncwarp();
    copy_staged<false>(lens, typs, sl, st, total, incl, excl, a, lane);
    __syncwarp();  // the next group's staging overwrites these slots
  }
}

// The persistent grid of a device: the CTAs of the kernel that fit on it at
// once, found once per device.
cudaError_t resident_ctas(int* ctas) {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*ctas = cached[dev].load()) > 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, esp_adjust_staged_kernel, 32 * WARPS, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *ctas = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < MAX_DEVICES) cached[dev].store(*ctas);
  return cudaSuccess;
}

}  // namespace

// lens, typs: int32 [size], adjusted in place; ws, we: int32 [max_spans],
// each span's [ws, we) of block indices; ns: int32 [1], the live spans.
extern "C" int tdc_esp_adjust(void* lens, void* typs, const void* ws, const void* we, const void* ns,
                              int max_spans, void* stream) {
  if (max_spans < 0) return (int)cudaErrorInvalidValue;
  if (max_spans == 0) return 0;
  int ctas = 0;
  const cudaError_t err = resident_ctas(&ctas);
  if (err != cudaSuccess) return (int)err;
  const long long groups = ((long long)max_spans + 32 * WARPS - 1) / (32 * WARPS);  // CTAs with a span to own
  const unsigned blocks = (unsigned)(groups < ctas ? groups : ctas);
  esp_adjust_staged_kernel<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(lens), static_cast<int32_t*>(typs), static_cast<const int32_t*>(ws),
      static_cast<const int32_t*>(we), static_cast<const int32_t*>(ns), max_spans);
  return (int)cudaGetLastError();
}
