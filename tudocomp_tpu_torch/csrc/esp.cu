// Kernel I (esp_adjust_windows): the adjust pass of one ESP round, one
// thread a span of blocks, the reference's 3-slot queue in registers.
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package's
// tudocomp_tpu/ops/esp_jax.py:_adjust_dev runs the queue machine of
// compressors/esp.py:_adjust_blocks (BlockAdjust.hpp:38-131) as
// _sim_window (esp_jax.py:87-199), a while_loop vmapped over spans by
// _tier_sim (:206-220), with lane caps (OC, CAP2, a widest span of 128
// blocks) past which the round falls back to the host. In PyTorch that loop
// is ~30 small launches and a host sync a step, hundreds of steps a round
// (ops/esp_kernels.py:esp_adjust_windows_plain, the plain version).
//
// The queue only ever changes blocks near a block of length 1: away from one
// it pops each block as it was filled. So the caller (ops/esp_torch.py:
// adjust_spans) cuts the round's blocks into spans, the unions of the
// [i - 3, i + 4) windows around the length-1 blocks i, as _adjust_dev
// builds them (heads at least 7 blocks apart, so spans never overlap), and
// passes each span's [ws, we) with the span count ns, which stays in device
// memory: the grid covers the static bound on spans, and threads past ns
// exit, so the launch needs no host sync.
//
// A thread runs the machine over its span's (len, type) pairs: fill (slot
// qn gets the next block) while the queue holds fewer than 3 and blocks
// remain, else merge the first pair the reference's step picks, else pop
// the front. A merge never adds a block, so the thread writes each popped
// block over its own span at the next output slot (which it has read
// already) and sets the lengths of the slots a merge freed to 0. The caller
// compacts the blocks with a cumsum and a scatter. The machine takes a span
// of any width, so the JAX package's caps and their fallback are gone.
//
// Bound on the H100: the function reads each span's blocks once and writes
// them once (16 bytes a block) plus 8 bytes a span; spans are a few blocks
// around each length-1 block, a small share of the round. What limits the
// kernel is the serial chain of each thread (three steps a block, each a
// dependent load or a handful of compares) and the scattered, uncoalesced
// reads of threads whose spans lie far apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void esp_adjust_kernel(int32_t* __restrict__ lens, int32_t* __restrict__ typs,
                                  const int32_t* __restrict__ ws, const int32_t* __restrict__ we,
                                  const int32_t* __restrict__ ns, int max_spans) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= max_spans || s >= *ns) return;
  const int a = ws[s];
  const int navail = we[s] - a;
  int32_t* L = lens + a;
  int32_t* T = typs + a;
  int l0 = 0, l1 = 0, l2 = 0, t0 = 0, t1 = 0, t2 = 0;
  int qn = 0, ip = 0, op = 0;
  while (qn > 0 || ip < navail) {
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
      continue;
    }
    // qn >= 1 here: the loop runs on while the queue holds a block
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
        continue;
      }
      if (qn >= 2 && (l0 == 1 || l1 == 1)) {  // merge q[0], q[1]
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
          continue;
        }
      }
    }
    // pop the front block into the next output slot
    L[op] = l0;
    T[op] = t0;
    ++op;
    l0 = l1; t0 = t1;
    l1 = l2; t1 = t2;
    --qn;
  }
  for (int j = op; j < navail; ++j) L[j] = 0;  // slots that merges freed
}

}  // namespace

// lens, typs: int32 [size], adjusted in place; ws, we: int32 [max_spans],
// each span's [ws, we) of block indices; ns: int32 [1], the live spans.
extern "C" int tdc_esp_adjust(void* lens, void* typs, const void* ws, const void* we, const void* ns,
                              int max_spans, void* stream) {
  if (max_spans < 0) return (int)cudaErrorInvalidValue;
  if (max_spans == 0) return 0;
  const unsigned blocks = (unsigned)((max_spans + THREADS - 1) / THREADS);
  esp_adjust_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(lens), static_cast<int32_t*>(typs), static_cast<const int32_t*>(ws),
      static_cast<const int32_t*>(we), static_cast<const int32_t*>(ns), max_spans);
  return (int)cudaGetLastError();
}
