"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `csrc/*.cu` are compiled with `nvcc` for Hopper (`sm_90a`),
one `nvcc` per source, all started together, and linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
lands in `build/tudocomp_tpu_torch/` at the repository root (git-ignored),
named by a hash of the sources and the flags, so a change to either
rebuilds. Nothing here runs at import: the first launch
builds, and code on the CPU never reaches this module's build.

Every launch goes through `launch`, which passes PyTorch's current stream,
raises when the launcher returns a CUDA error, and counts the launch under
the kernel's name (`counts`, `reset_counts`).
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

__all__ = ["build", "counts", "launch", "reset_counts", "KERNELS"]

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
        [_P, _P, _P, _P, _P, _I, _L, _I, _P, _P, _P, _P, _P],
    ),
    "tdc_huffman_tables": ("huffman_tables", [_P, _I, _P, _P, _P, _P, _P, _P, _P]),
    "tdc_moffat_phase12": ("moffat_phase12", [_P, _P, _I, _P, _P]),
    "tdc_decode_payloads": ("decode_payloads", [_P, _L, _P, _P, _P, _P, _I, _P, _L, _P, _P]),
    "tdc_lz78_parse": ("lz78_parse", [_P, _L, _P, _I, _P, _I, _P, _P, _P, _P]),
    "tdc_lzw_parse": ("lzw_parse", [_P, _L, _P, _I, _P, _I, _P, _P, _P]),
}

_counts = {name: 0 for name, _ in KERNELS.values()}
_lib = None
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


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, (_, argtypes) in KERNELS.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(fn: str, *args) -> None:
    """Run launcher `fn` on the current CUDA stream; count it; raise on error.

    Tensor arguments pass their data pointers; the stream is appended."""
    lib = _load()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, fn)(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    _counts[KERNELS[fn][0]] += 1


def counts() -> dict[str, int]:
    """Launches per kernel since the last reset_counts()."""
    return dict(_counts)


def reset_counts() -> None:
    for k in _counts:
        _counts[k] = 0
