// Kernel H (plcp_segments): the permuted LCP array by Kärkkäinen's
// phi-algorithm, one warp per text segment, in levels.
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package's
// tudocomp_tpu/ops/plcp_jax.py:plcp_device walks S segments in lockstep under
// one XLA while_loop, a word compare per lane and step; in PyTorch that loop
// is thousands of steps of a dozen small launches each
// (ops/plcp_torch.py:plcp_device_plain). Here every segment is one warp that
// runs the sequential algorithm (reference ds/PLCPFromPhi.hpp:38-44) on its
// positions: plcp[i] starts from plcp[i - 1] - 1, so a segment's compares
// telescope to its length plus the LCP of its first position. The warp
// compares 32 bytes a step (a ballot finds the first mismatch) and fetches
// phi 32 positions at a time, so neither the byte loads nor the phi loads
// sit in a chain of dependent loads.
//
// A segment's first position has no predecessor to start from. On a text
// with long repeats (one letter, a file twice over) its LCP is of the text's
// order, and one such walk per segment is quadratic work. So the kernel runs
// in levels, coarsest first: plcp[i + s] >= plcp[i] - s holds for any stride
// s, so level k walks the positions that are multiples of seg^k the same
// way, in segments of seg of them, each starting from the value the level
// above left at its first position. Only the few positions of the top level
// (at most seg or so) start from 0, each with a warp of its own.
//
// Bound on the H100: the text, phi and plcp each cross the memory bus once
// (9 bytes a position); what limits it is the chain of steps of each warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Positions k * stride < n - 1, k counted from 0; warp w takes k in
// [w * per, (w + 1) * per). With `known` the first of them holds its value
// already (the level above wrote it) and only seeds l.
__global__ void plcp_level_kernel(const uint8_t* __restrict__ text,
                                  const int32_t* __restrict__ phi, int64_t n, int64_t stride,
                                  int per, bool known, int32_t* __restrict__ plcp) {
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t count = (n - 1 + stride - 1) / stride;  // position n - 1 keeps 0
  const int64_t first = w * per;
  if (first >= count) return;
  const int64_t last = first + per < count ? first + per : count;
  int64_t l = known ? plcp[first * stride] : 0;
  int32_t chunk = 0;
  for (int64_t k = first; k < last; ++k) {
    const int j = (int)((k - first) & 31);
    if (j == 0) chunk = k + lane < last ? phi[(k + lane) * stride] : 0;
    const int64_t i = k * stride;
    const int64_t p = __shfl_sync(FULL, chunk, j);
    if (!(known && k == first)) {
      for (;;) {
        const int64_t a = i + l + lane, b = p + l + lane;
        const bool eq = a < n && b < n && text[a] == text[b];
        const unsigned miss = __ballot_sync(FULL, !eq);
        if (miss) {
          l += __ffs(miss) - 1;
          break;
        }
        l += 32;
      }
      if (lane == 0) plcp[i] = (int32_t)l;
    }
    l = l > stride ? l - stride : 0;
  }
}

}  // namespace

// text [n] u8, phi [n] i32 -> plcp [n] i32 (zeroed by the caller); segments
// of `seg` positions at every level.
extern "C" int tdc_plcp_segments(const void* text, const void* phi, long long n, int seg,
                                 void* plcp, void* stream) {
  if (n <= 1) return 0;
  if (seg < 2) return (int)cudaErrorInvalidValue;
  int64_t strides[64];
  int levels = 0;
  for (int64_t s = 1; levels < 64; s *= seg) {
    strides[levels++] = s;
    if (s >= (n + seg - 1) / seg) break;  // at most seg or so positions at this stride
  }
  const int threads = 128;  // four warps
  for (int k = levels - 1; k >= 0; --k) {
    const bool top = k == levels - 1;
    const int64_t count = (n - 1 + strides[k] - 1) / strides[k];
    const int per = top ? 1 : seg;
    const int64_t warps = (count + per - 1) / per;
    const unsigned grid = (unsigned)((warps * 32 + threads - 1) / threads);
    plcp_level_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(text), static_cast<const int32_t*>(phi), n, strides[k], per,
        !top, static_cast<int32_t*>(plcp));
  }
  return (int)cudaGetLastError();
}
