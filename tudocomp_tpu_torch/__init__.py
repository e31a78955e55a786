"""tudocomp_tpu_torch: the PyTorch and CUDA port of tudocomp_tpu.

The port runs the block-parallel canonical Huffman path,
`blockwise(encode(huff))` with per-block or shared tables, and the
blockwise LZ78/LZW parse on one NVIDIA Hopper GPU through hand-written
CUDA kernels (csrc/), and on the CPU through those kernels' plain PyTorch
versions. It imports neither jax nor tudocomp_tpu: the host layers it
needs (io, meta, dsl, the registry, the coders, the LZ78/LZW compressors,
TBK1 framing, stats, the C++ host helpers) are its own copies.

    from tudocomp_tpu_torch.driver import compress, decompress
    c = compress("blockwise(encode(huff))", data, device="cuda")
    assert decompress(c, device="cuda") == data
"""

__version__ = "0.1.0"
