"""ctypes loader for the port's C++ host helpers (csrc/host/tdc_host.cpp).

The port's copy of tudocomp_tpu/native.py, trimmed to the entry points the
port's host layers call: the LZ78/LZW parses and decodes, the token pack
and read of the bit writer and reader, the canonical Huffman bulk decodes,
the segmented token interleave, and the suffix stack of lzss_lcp (SA-IS,
PLCP, the permutation helpers, the SparseISA build, the LZSS factorizer and
the lzss stream parse and factor copy), the ESP round, the SLP's expansion,
the canonical index decode and the longest increasing subsequence of the
esp coders, the arithmetic coder's loops, and lcpcomp's six factorization
strategies, factor flatten and four decoders, the RLE decode, the MTF
encode and decode, the BWT's LF walk, the sliding-window lzss parse and
Re-Pair's build and expansion: 42 entry points. The library
is built with g++ at first use into `build/tudocomp_tpu_torch/` at the
repository root (git-ignored), named by a hash of the source, so a change rebuilds. Every caller keeps a
pure-Python fallback, so the host path runs, slower, where no compiler is
found: this is host code, not a device fallback.

`memhook_so_path` builds the malloc interposer (csrc/host/tdc_memhook.c,
the port's copy of native/tdc_memhook.c) the same way, with `g++ -x c`,
for the command line's TDC_MALLOC_HOOK=1, and raises where it cannot;
`memhook_counters` reads its counters where it is preloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["get_lib", "memhook_counters", "memhook_so_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_PKG, "csrc", "host", "tdc_host.cpp")
_MEMHOOK_SRC = os.path.join(_PKG, "csrc", "host", "tdc_memhook.c")
_MEMHOOK_FLAGS = ("-x", "c", "-std=gnu11", "-O2", "-fPIC", "-shared")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tudocomp_tpu_torch")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libtdc_host-{h.hexdigest()[:16]}.so")


def _compile(so_path: str, flags, src: str, libs=()) -> str:
    """Compile to a file of this process's own, then rename it into place,
    so that processes building at once never load a half-written library.
    Returns "" on success, else the compiler's complaint."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}"
    try:
        r = subprocess.run(["g++", *flags, "-o", tmp, src, *libs], capture_output=True, timeout=240)
        if r.returncode != 0:
            return r.stderr.decode(errors="replace") or f"g++ exited with {r.returncode}"
        os.replace(tmp, so_path)
        return ""
    except Exception as e:
        return repr(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    u8p, u32p, i64p, u64p = arr(np.uint8), arr(np.uint32), arr(np.int64), arr(np.uint64)
    i32p = arr(np.int32)
    signatures = {
        "tdc_lz78_parse": (i64, [u8p, i64, u32p, u8p]),
        "tdc_lz78_decode": (i64, [u32p, u8p, i64, u8p, i64]),
        "tdc_lzw_parse": (i64, [u8p, i64, u32p]),
        "tdc_lzw_decode": (i64, [u32p, i64, u8p, i64]),
        "tdc_huffman_decode": (i64, [u8p, i64, i64, u8p, u8p, i32, u8p, i64]),
        "tdc_huffman_decode_canonical": (i64, [u8p, i64, i64, u64p, i64p, u8p, i32, u8p, i64]),
        "tdc_pack_tokens": (i64, [u64p, i64p, i64, u8p, i64]),
        "tdc_read_tokens": (i64, [u8p, i64, i64, i64p, i64, u64p]),
        "tdc_segment_interleave": (
            i64, [u64p, i64p, i64p, i64p, i64p, i64p, i64, i64, u64p, i64p],
        ),
        "tdc_sais": (i32, [u8p, i64, i32p]),
        "tdc_plcp_from_phi": (None, [u8p, i64, i32p, i32p]),
        "tdc_inverse_perm": (None, [i32p, i64, i32p]),
        "tdc_gather_i32": (None, [i32p, i32p, i64, i32p]),
        "tdc_phi_from_sa": (None, [i32p, i64, i32p]),
        "tdc_sparse_isa_build": (None, [i64p, i64, i64, u8p, i64p]),
        "tdc_lzss_lcp_factorize": (i64, [i32p, i32p, i32p, i64, i64, u32p, u32p, u32p]),
        "tdc_lzss_stream_parse": (
            i64,
            [u8p, i64, i64, i64, i64, i64, i64, i64, i32, u64p, i64p, u8p, i32,
             u8p, u32p, u32p, u32p, i64p],
        ),
        "tdc_lzss_apply_factors": (None, [u8p, u32p, u32p, u32p, i64]),
        "tdc_esp_round": (i64, [u32p, i64, i64, u32p, u32p, u32p, i64p]),
        "tdc_esp_derive": (i64, [i32p, i32p, i64, i64, u8p, i64]),
        "tdc_canonical_decode_idx": (i64, [u8p, i64, i64, i64p, i64p, i64, i32p, i64]),
        "tdc_arith_encode": (i64, [u8p, i64, u32p, ctypes.c_uint64, u64p]),
        "tdc_arith_decode": (i64, [u64p, i64, u8p, u32p, i32, ctypes.c_uint64, i64, u8p]),
        "tdc_lis_indices": (i64, [i64p, i64, i64p]),
        "tdc_lcpcomp_flatten": (None, [u32p, u32p, u32p, i64]),
        "tdc_lcpcomp_scan_decode": (i32, [u8p, i64, u32p, u32p, u32p, i64, i64]),
        "tdc_lcpcomp_compact_decode": (i32, [u8p, i64, u32p, u32p, u32p, i64]),
        "tdc_lcpcomp_queuelist_decode": (i32, [u8p, i64, u32p, u32p, u32p, i64]),
        "tdc_lcpcomp_multimap_decode": (i32, [u8p, i64, u32p, u32p, u32p, i64, i64]),
        "tdc_rle_decode": (i64, [u8p, i64, i64, u8p, i64]),
        "tdc_mtf_decode": (None, [u8p, i64, u8p]),
        "tdc_mtf_encode": (None, [u8p, i64, u8p]),
        "tdc_bwt_walk": (None, [u8p, i64p, i64, u8p]),
        "tdc_lzss_window_parse": (i64, [u8p, i64, i64, i64, u8p, u32p, u32p, u32p]),
        "tdc_repair_build": (i64, [u32p, i64, i64, u32p, u32p, i64p]),
        "tdc_repair_expand": (i64, [u32p, u32p, i64, u32p, i64, u8p, i64]),
    }
    for strategy in ("arrays", "heap", "bheap", "plcp", "maxlcp", "plcppeaks"):
        # (sa, isa, lcp or plcp, n, threshold, fpos, fsrc, flen) -> factors
        signatures[f"tdc_lcpcomp_{strategy}_factorize"] = (i64, [i32p, i32p, i32p, i64, i64, u32p, u32p, u32p])
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded host library, building it on first use; None where it
    cannot be built or loaded (the callers then take their Python paths)."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            so_path = _so_path()
            if os.path.exists(so_path) or not _compile(so_path, _FLAGS, _SRC_PATH):
                try:
                    lib = ctypes.CDLL(so_path)
                    _bind(lib)
                    _lib = lib
                except OSError:
                    pass
    return _lib


def memhook_so_path() -> str:
    """Path of the LD_PRELOAD malloc interposer (csrc/host/tdc_memhook.c),
    built at first use into build/tudocomp_tpu_torch/ and named by a hash
    of its source and flags. Raises RuntimeError where it cannot be built:
    a run that asked for the interposer's numbers gets them or fails."""
    h = hashlib.sha256(" ".join(_MEMHOOK_FLAGS).encode())
    with open(_MEMHOOK_SRC, "rb") as f:
        h.update(f.read())
    so = os.path.join(_BUILD_DIR, f"libtdc_memhook-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        err = _compile(so, _MEMHOOK_FLAGS, _MEMHOOK_SRC, ("-ldl",))
        if err:
            raise RuntimeError(f"the malloc interposer did not build: {err.strip()[-2000:]}")
    return so


def memhook_counters():
    """(current_fn, peak_fn, reset_peak_fn) when the malloc interposer is
    preloaded into this process; None otherwise."""
    try:
        lib = ctypes.CDLL(None)
        lib.tdc_memhook_active  # raises if not preloaded
    except (AttributeError, OSError):
        return None
    lib.tdc_mem_current.restype = ctypes.c_longlong
    lib.tdc_mem_peak.restype = ctypes.c_longlong
    return lib.tdc_mem_current, lib.tdc_mem_peak, lib.tdc_mem_reset_peak
