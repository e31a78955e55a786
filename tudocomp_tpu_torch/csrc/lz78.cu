// Kernels E (lz78_parse) and F (lzw_parse): the LZ78 and LZW trie parses of
// many independent blocks.
//
// Kernel E replaces tudocomp_tpu/ops/lz78_pallas.py:_lz78_kernel (128 blocks
// of at most 8 KiB in lockstep) and tudocomp_tpu/ops/lz78_bucket_pallas.py:
// _lz78_bucket_kernel (one block of at most 256 KiB per program). Both compute
// one function, the factors (parent node, char) of the host tdc_lz78_parse,
// the trailing partial factor included (LZ78Compressor.hpp:124-131): factor i
// creates node i + 1, so a block that ends inside node k > 0 re-emits factor
// k - 1. Kernel F replaces lz78_pallas.py:_lzw_kernel, the codes of the host
// tdc_lzw_parse: 256 implicit roots, a miss emits the current node, creates
// node 256 + nf and restarts at the byte; a non-empty block always emits its
// final node. Positions at or past n_valid[b] are never read.
//
// Design. One thread parses one block: the parse is a chain of dependent
// dictionary probes, so the parallelism is across blocks only. Each block
// owns an open-addressing hash table in device memory, allocated by the
// wrapper with every slot all ones. A slot is one 64-bit word, the key
// (node << 8) | c in its low half and the child's node id in its high half,
// so a probe is one load; 0xFFFFFFFF is the empty key (key 0, node 0 and
// byte 0, is a valid key). Linear probing; the slot count is a power of two
// at least 2 (bs + 2), so the table is at most half full. The TPU kernels'
// lockstep content scan and store-extract-reload bucket walk were Mosaic
// workarounds and are not carried over, nor are their block-size caps: one
// kernel takes every block size whose node ids fit 24 bits.
//
// Bound on the H100: the latency of one thread's probe chain, about one load
// from device memory per input byte (the tables, 16 bytes of slot per byte
// of block, outgrow the 50 MB L2 at the main path's sizes), with only B
// threads in flight: 200 at bs 256 KiB against 132 SMs, 6400 at 8 KiB. The
// design does nothing about that yet; ROADMAP.md names the redesign (a warp
// probing a bucket of slots at once, the table in shared memory for
// bs <= 8 KiB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // blocks per CTA: one warp
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

struct Dict {
  unsigned long long* slots;
  int shift;      // 32 - log2(slot count)
  uint32_t mask;  // slot count - 1

  // The child stored under `key`; where there is none, inserts `new_id`
  // under it and sets *miss.
  __device__ uint32_t find_or_insert(uint32_t key, uint32_t new_id, bool* miss) const {
    uint32_t h = (key * 0x9E3779B1u) >> shift;
    for (;;) {
      const unsigned long long e = slots[h];
      const uint32_t k = (uint32_t)e;
      if (k == key) {
        *miss = false;
        return (uint32_t)(e >> 32);
      }
      if (k == EMPTY) {
        slots[h] = ((unsigned long long)new_id << 32) | key;
        *miss = true;
        return new_id;
      }
      h = (h + 1) & mask;
    }
  }
};

__device__ Dict block_dict(unsigned long long* table, int b, int log2_slots) {
  const long long slots = 1LL << log2_slots;
  return Dict{table + (long long)b * slots, 32 - log2_slots, (uint32_t)(slots - 1)};
}

__global__ void __launch_bounds__(THREADS)
lz78_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
            unsigned long long* table, int log2_slots, int32_t* parents, uint8_t* chars,
            int32_t* nf_out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const Dict d = block_dict(table, b, log2_slots);
  const uint8_t* t = text + (long long)b * bs;
  int32_t* par = parents + (long long)b * (bs + 1);
  uint8_t* chr = chars + (long long)b * (bs + 1);
  const int n = n_valid[b];
  uint32_t node = 0, nf = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t c = t[i];
    bool miss;
    const uint32_t child = d.find_or_insert((node << 8) | c, nf + 1, &miss);
    if (miss) {
      par[nf] = (int32_t)node;
      chr[nf] = (uint8_t)c;
      ++nf;
      node = 0;
    } else {
      node = child;
    }
  }
  if (node > 0) {  // trailing partial factor: the one that created node
    par[nf] = par[node - 1];
    chr[nf] = chr[node - 1];
    ++nf;
  }
  nf_out[b] = (int32_t)nf;
}

__global__ void __launch_bounds__(THREADS)
lzw_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
           unsigned long long* table, int log2_slots, int32_t* codes, int32_t* nf_out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const Dict d = block_dict(table, b, log2_slots);
  const uint8_t* t = text + (long long)b * bs;
  int32_t* out = codes + (long long)b * bs;
  const int n = n_valid[b];
  uint32_t nf = 0;
  if (n > 0) {
    uint32_t node = t[0];
    for (int i = 1; i < n; ++i) {
      const uint32_t c = t[i];
      bool miss;
      const uint32_t child = d.find_or_insert((node << 8) | c, 256 + nf, &miss);
      if (miss) {
        out[nf++] = (int32_t)node;
        node = c;
      } else {
        node = child;
      }
    }
    out[nf++] = (int32_t)node;  // the final phrase
  }
  nf_out[b] = (int32_t)nf;
}

}  // namespace

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// parents [B, bs + 1] i32, chars [B, bs + 1] u8 (factors from slot 0), nf [B] i32.
extern "C" int tdc_lz78_parse(const void* text, long long bs, const void* n_valid, int B,
                              void* table, int log2_slots, void* parents, void* chars, void* nf,
                              void* stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  lz78_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(parents),
      static_cast<uint8_t*>(chars), static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// codes [B, bs] i32 (from slot 0), nf [B] i32.
extern "C" int tdc_lzw_parse(const void* text, long long bs, const void* n_valid, int B,
                             void* table, int log2_slots, void* codes, void* nf, void* stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  lzw_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(codes),
      static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}
