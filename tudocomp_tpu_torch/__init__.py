"""tudocomp_tpu_torch: the PyTorch and CUDA port of tudocomp_tpu.

The port runs the block-parallel canonical Huffman path,
`blockwise(encode(huff))` with per-block or shared tables, the blockwise
LZ78/LZW parse, and `lzss_lcp` (alone and under `blockwise`) with its
suffix array and LZSS factorization on one NVIDIA Hopper GPU: through
hand-written CUDA kernels (csrc/) and plain PyTorch on the card, and on the
CPU through those kernels' plain PyTorch versions. `python -m
tudocomp_tpu_torch.probes` runs the pack kernel's primitives one at a time.
It imports neither jax nor tudocomp_tpu: the host layers it needs (io,
meta, dsl, the registry, the coders, the LZ78/LZW and LZSS compressors, the
text data structures, TBK1 framing, stats, the C++ host helpers) are its
own copies.

    from tudocomp_tpu_torch.driver import compress, decompress
    c = compress("blockwise(encode(huff))", data, device="cuda")
    assert decompress(c, device="cuda") == data
"""

__version__ = "0.1.0"
