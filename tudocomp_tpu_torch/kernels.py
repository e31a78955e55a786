"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `csrc/*.cu` are compiled with `nvcc` for Hopper (`sm_90a`),
one `nvcc` per source, all started together, and linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
lands in `build/tudocomp_tpu_torch/` at the repository root (git-ignored),
named by a hash of the sources and the flags, so a change to either
rebuilds. Nothing here runs at import: the first launch
builds, and code on the CPU never reaches this module's build.

Every launch goes through `launch`, which runs the launcher on the CUDA
device its tensor arguments lie on, with that device's current stream,
raises when the launcher returns a CUDA error, and counts the launch under
the kernel's name (`counts`, `reset_counts`) in the port's counter registry
(stats/counters.py, as `launch.<name>`). Tensors on two CUDA devices
raise `ValueError`. Where the tensors' device is the current one, nothing
is switched; otherwise it is made current for the call (a `<<<>>>` launch
goes to the current device's context, whatever stream it is given) and
the previous device is restored after. The library is loaded once, under
a lock; after that a launch takes no lock: it looks its ctypes function up
in a dict filled at load, reads the device's current raw stream handle
(no `torch.cuda.Stream` object is built), and calls. A kernel that reports
a bad input writes a flag word in pinned host memory mapped for the card
(`launch_flagged`): the host zeroes the word, launches, waits for the
stream once and reads the word, with no device allocation, memset or copy
back. The word is one per device, so a per-device lock holds those four
steps together when threads launch on one device at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .stats import counters

__all__ = ["build", "counts", "helper", "launch", "launch_flagged", "reset_counts", "HELPERS", "KERNELS"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tudocomp_tpu_torch")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# launcher name -> (counter name, argument types); every launcher returns
# cudaGetLastError() as an int and takes the stream last
KERNELS = {
    "tdc_pack_blocks": ("pack_blocks", [_P, _P, _I, _L, _I, _P, _P, _P, _P, _P]),
    "tdc_pack_bytes_blocks": (
        "pack_bytes_blocks",
        [_P, _P, _P, _P, _L, _P, _L, _I, _P, _L, _I, _L, _I, _P, _P, _P, _P, _P],
    ),
    "tdc_huffman_tables": ("huffman_tables", [_P, _I, _P, _P, _P, _P, _P, _P, _P]),
    "tdc_huffman_tables64": ("huffman_tables64", [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "tdc_moffat_phase12": ("moffat_phase12", [_P, _P, _I, _P, _P]),
    "tdc_decode_payloads": ("decode_payloads", [_P, _L, _P, _P, _P, _P, _I, _P, _L, _P, _P, _P]),
    "tdc_lz78_parse": ("lz78_parse", [_P, _L, _P, _I, _P, _I, _P, _P, _P, _P]),
    "tdc_lzw_parse": ("lzw_parse", [_P, _L, _P, _I, _P, _I, _P, _P, _P]),
    "tdc_plcp_segments": ("plcp_segments", [_P, _P, _L, _I, _P, _P, _P]),
    "tdc_esp_adjust": ("esp_adjust_windows", [_P, _P, _P, _P, _P, _I, _P]),
    "tdc_mtf_encode_chunks": ("mtf_encode", [_P, _L, _P, _P, _I, _P]),
    # csrc/probes.cu
    "tdc_probe3_gather": ("probe3_gather", [_P, _P, _P, _I, _L, _L, _P, _P, _P]),
    "tdc_probe6_roll_lane": ("probe6_roll_lane", [_P, _P, _P]),
    "tdc_probe6_roll_sublane": ("probe6_roll_sublane", [_P, _P, _P]),
    "tdc_probe6_extract": ("probe6_extract", [_P, _P, _P]),
    "tdc_probe6_bid": ("probe6_bid", [_P, _P, _P]),
    "tdc_probe6_dot3": ("probe6_dot3", [_P, _P, _P]),
    "tdc_probe6_rmw": ("probe6_rmw", [_P, _P, _I, _P, _P]),
    "tdc_probe6_shift": ("probe6_shift", [_P, _P, _P]),
    "tdc_probe7_pack": ("probe7_pack", [_P, _P, _I, _L, _I, _P, _P, _I, _P, _P, _P]),
    "tdc_probe8_a": ("probe8_a", [_P, _I, _I, _I, _P, _P, _P]),
    "tdc_probe8_b": ("probe8_b", [_P, _I, _I, _I, _P, _P, _P]),
    "tdc_probe8_c": ("probe8_c", [_P, _I, _I, _I, _P, _P, _P]),
    "tdc_probe8_d": ("probe8_d", [_P, _I, _I, _I, _P, _P, _P]),
}

# host helpers of csrc/launch.cu and csrc/lz78.cu, which launch nothing: name -> (result type, argument types)
HELPERS = {
    "tdc_mapped_word": (_P, [_I, ctypes.POINTER(_P)]),
    "tdc_stream_wait": (_I, [_P]),
    "tdc_parse_occupancy": (_I, [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]),
}

_NAMES = tuple(name for name, _ in KERNELS.values())
_lib = None
_fns: dict[str, tuple] = {}  # launcher -> (ctypes function, registry counter), filled once by _load
_flags: dict[int, tuple] = {}  # device index -> (host word, device pointer, lock)
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libtdc_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists; return its path."""
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    procs = [
        subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(_sources(), objs)
    ]
    errors = []
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(p.args)} ({p.returncode}):\n{err}")
    if not errors:
        r = subprocess.run([_nvcc(), *_FLAGS, "-shared", "-o", f"{tmp}.so", *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            errors.append(f"link ({r.returncode}):\n{r.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    os.replace(f"{tmp}.so", so)
    return so


def _stream(device: int) -> int:
    """The raw handle of CUDA device `device`'s current stream (what
    torch.cuda.current_stream(device).cuda_stream gives, without the Stream
    object; a torch.cuda.stream(...) context sets it)."""
    return torch._C._cuda_getCurrentRawStream(device)


def _pointers(args) -> tuple[list, int]:
    """args with every tensor replaced by its data pointer, and the index
    of the CUDA device the tensors lie on (-1: none lies on one)."""
    out, idx = [], -1
    for a in args:
        if isinstance(a, torch.Tensor):
            d = a.get_device()
            if d != idx and d >= 0:
                if idx >= 0:
                    raise ValueError(f"kernel arguments on CUDA devices {idx} and {d}")
                idx = d
            out.append(a.data_ptr())
        else:
            out.append(a)
    return out, idx


def _switched(idx: int, call, *args):
    """call(idx, *args) with CUDA device `idx` made current, the previous
    device restored after."""
    prev = torch._C._cuda_exchangeDevice(idx)
    try:
        return call(idx, *args)
    finally:
        torch._C._cuda_maybeExchangeDevice(prev)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fns = {}
            for fn, (name, argtypes) in KERNELS.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
                fns[fn] = (f, "launch." + name)
            for fn, (restype, argtypes) in HELPERS.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            _fns.update(fns)
            _lib = lib
    return _lib


def _call(device: int, fn: str, ptrs: list) -> None:
    """Launcher `fn` on current device `device`'s current stream; counted."""
    entry = _fns.get(fn)
    if entry is None:
        _load()
        entry = _fns[fn]
    f, counter = entry
    rc = f(*ptrs, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    counters.add(counter)


def launch(fn: str, *args) -> None:
    """Run launcher `fn` on the current stream of the CUDA device its tensor
    arguments lie on; count it; raise on error.

    Tensor arguments pass their data pointers; the stream is appended."""
    ptrs, idx = _pointers(args)
    cur = torch._C._cuda_getDevice()
    if idx < 0 or idx == cur:
        _call(cur, fn, ptrs)
    else:
        _switched(idx, _call, fn, ptrs)


def helper(name: str):
    """The loaded ctypes function of host helper `name` (HELPERS)."""
    if name not in HELPERS:
        raise KeyError(name)
    return getattr(_load(), name)


def _flag(device: int) -> tuple:
    """(host word, device pointer, lock) of the device's mapped flag, allocated once."""
    flag = _flags.get(device)
    if flag is None:
        lib = _load()
        with _lock:
            if device not in _flags:
                dptr = ctypes.c_void_p()
                host = lib.tdc_mapped_word(device, ctypes.byref(dptr))
                if not host:
                    raise RuntimeError("tdc_mapped_word: no mapped host memory")
                _flags[device] = (ctypes.c_int32.from_address(host), dptr.value, threading.Lock())
        flag = _flags[device]
    return flag


def launch_flagged(fn: str, *args) -> int:
    """launch(fn, *args, flag) with the mapped flag word of the tensors'
    device, zeroed first; waits for that device's current stream and
    returns the word (0 when the kernel found nothing to report). The word
    is one per device; its lock keeps the zeroing, launch, wait and read of
    one call from interleaving with another thread's on that device."""
    ptrs, idx = _pointers(args)
    cur = torch._C._cuda_getDevice()
    if idx < 0 or idx == cur:
        return _flagged(cur, fn, ptrs)
    return _switched(idx, _flagged, fn, ptrs)


def _flagged(device: int, fn: str, ptrs: list) -> int:
    word, dptr, lock = _flag(device)
    with lock:
        word.value = 0
        _call(device, fn, [*ptrs, dptr])
        rc = _lib.tdc_stream_wait(_stream(device))
        if rc != 0:
            raise RuntimeError(f"{fn}: CUDA error {rc}")
        return word.value


def counts() -> dict[str, int]:
    """Launches per kernel since the last reset_counts(), every kernel named."""
    snap = counters.snapshot()
    return {name: snap.get("launch." + name, 0) for name in _NAMES}


def reset_counts() -> None:
    """Zero every counter of the registry, the launches among them."""
    counters.reset()
