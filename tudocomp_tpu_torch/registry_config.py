"""The official algorithm matrix (mirror of etc/registry_config.py).

The port's copy of tudocomp_tpu/registry_config.py. The reference generates
its registry from a Python config declaring which algorithm combinations
are valid — notably which coder *groups* each compressor accepts
(consuming coders like arithmetic/sle buffer literals and are excluded
from interleaved formats; see Documentation.md:1190-1203). This module
declares the same matrix over the port's ids; tests/test_torch_matrix.py
roundtrips every combination, mirroring test/matrix_tests.cpp.
"""

from __future__ import annotations

from itertools import product

# Coder groups (etc/registry_config.py:13-37)
UNIVERSAL_CODERS = ["ascii", "bit", "gamma", "delta"]
# NEW beyond the reference: byte-aligned varint coder (BASELINE config 1)
EXTRA_CODERS = ["vbyte"]
ENTROPY_CODERS = ["huff"]
CONSUMING_ENTROPY_CODERS = ["arithmetic", "sle"]
NON_CONSUMING_CODERS = UNIVERSAL_CODERS + ENTROPY_CODERS
ALL_CODERS = NON_CONSUMING_CODERS + CONSUMING_ENTROPY_CODERS

# LZ78 tries (etc/registry_config.py:109-120)
LZ78_TRIES = [
    "binarysorted",
    "binary",
    "cedar",
    "exthash",
    "hash",
    "hash_plus",
    "rolling",
    "rolling_plus",
    "ternary",
    "compact_sparse_hash",
]

# lcpcomp axes (etc/registry_config.py:139-166)
LCPCOMP_CODERS = ["ascii", "sle", "huff"]
# bheap + plcp are Boost-gated optional strategies in the reference
# (etc/registry_config.py:152-156); always available here
LCPCOMP_COMP = ["heap", "max_lcp", "arrays", "plcppeaks", "bheap", "plcp"]
LCPCOMP_DEC = ["scan", "QueueListBuffer", "compact", "MultimapListBuffer"]

# esp axes (etc/registry_config.py:174-205)
ESP_SLP_CODERS = [
    "plain",
    "sorted",  # default d_coding = succinct (DMonotonSubseq)
    "sorted(d_coding=plain)",
    "sorted(d_coding=huffman)",
    "sorted(d_coding=diff)",
    "sorted(d_coding=wavelet_tree)",
    "sorted(d_coding=range_fit)",
    "sorted(d_coding=range_fit(wt=true))",
    "sorted(d_coding=range_fit(threshold=25, wt=true, zero_min=true))",
    "sorted(d_coding=succinct(subseq=optimal, dx_coder=plain))",
    "sorted(d_coding=succinct(subseq=greedy, dx_coder=huffman))",
    "sorted(d_coding=succinct(subseq=greedy, dx_coder=wavelet_tree))",
    # NEW beyond the reference (BASELINE config 4 "esp + arithmetic")
    "sorted(d_coding=arith)",
]
ESP_IPD = ["std_unordered_map", "hash_map", "dynamic_size"]

# lfs axes (etc/registry_config.py:207-225)
LFS_STRATS = ["esa", "st", "bst", "sim_st"]
LFS_LIT_CODERS = ["bit", "ascii", "huff"]
LFS_LEN_CODERS = UNIVERSAL_CODERS


def compressor_matrix(fast: bool = False) -> list[str]:
    """Every valid static compressor configuration as an id string.

    Mirror of COMPRESSOR_REGISTRY.all_algorithms_with_static over the
    reference's registered matrix (etc/registry_config.py:227-245). With
    fast=True, large cross products are reduced to representative picks
    (the FAST_MATRIX idea, Documentation.md:356-362).
    """
    tries = LZ78_TRIES[:2] + ["ternary"] if fast else LZ78_TRIES
    uni = ["bit"] if fast else UNIVERSAL_CODERS

    ids: list[str] = []
    ids += ["noop", "rle", "mtf"]
    ids += [f"encode(coder={c})" for c in ALL_CODERS + EXTRA_CODERS]
    ids += ["bwt"]
    for c, t in product(uni, tries):
        ids.append(f"lz78(coder={c}, lz78trie={t})")
        ids.append(f"lzw(coder={c}, lz78trie={t})")
    ids += [f"lzss(coder={c})" for c in UNIVERSAL_CODERS]
    ids += [f"lzss_lcp(coder={c})" for c in NON_CONSUMING_CODERS]
    ids += [f"repair(coder={c})" for c in NON_CONSUMING_CODERS]
    for c, comp, dec in product(
        LCPCOMP_CODERS, LCPCOMP_COMP if not fast else ["arrays"], LCPCOMP_DEC
    ):
        ids.append(f"lcpcomp(coder={c}, comp={comp}, dec={dec})")
    for sc, c in product(["streaming"], UNIVERSAL_CODERS if not fast else uni):
        for rc in UNIVERSAL_CODERS if not fast else uni:
            ids.append(f"lz78u(comp={sc}(string_coder={c}), coder={rc})")
    for slp, ipd in product(ESP_SLP_CODERS, ESP_IPD):
        ids.append(f"esp(slp_coder={slp}, ipd={ipd})")
    for strat, lit, ln in product(
        LFS_STRATS if not fast else ["esa"],
        LFS_LIT_CODERS if not fast else ["huff"],
        LFS_LEN_CODERS if not fast else ["gamma"],
    ):
        ids.append(
            "lfs_comp(computing_strat="
            f"{strat}, coding_strat=lfs_enocde_strat("
            f"lfs_lit_coder={lit}, lfs_len_coder={ln}))"
        )
    ids += ["lfs2", "lfs2bst"]
    # textds provider axis (etc/registry_config.py:72-75, 158, 227, 238):
    # succinct providers routed through bwt/lzss_lcp/lcpcomp
    if not fast:
        ids += [
            "bwt(textds=textds(isa=sparse_isa))",
            "bwt(textds=textds(lcp=compressed_lcp))",
            "lzss_lcp(coder=huff, textds=textds(isa=sparse_isa(t=2)))",
            "lzss_lcp(coder=bit, textds=textds(lcp=compressed_lcp))",
            "lzss_lcp(coder=huff, textds=textds(lcp=compressed_lcp, isa=sparse_isa))",
            "lcpcomp(coder=huff, textds=textds(isa=sparse_isa))",
            "lcpcomp(coder=huff, comp=plcppeaks, textds=textds(lcp=compressed_lcp))",
        ]
    ids += ["blockwise(encode(huff), bs=16384)", "blockwise(lzw, bs=16384)"]
    ids += ["chain(bwt, chain(rle, chain(mtf, encode(huff))))"]
    return ids
