"""The probe entry points: the pack kernel's primitives, one at a time.

    python -m tudocomp_tpu_torch.probes [3|6|7|8 ...] [--device cuda|cpu]

The port of four measurement scripts of the JAX package (etc/probe3.py,
probe6.py, probe7.py, probe8.py). Each script ran the primitives a bit-pack
kernel is made of (a vector gather, rotations and scans, a scalar taken out
of a vector, a one-hot scatter, a windowed read-modify-write, variable
shifts) as small Pallas kernels, to see what compiles and what it costs.
Here each primitive is a hand-written CUDA kernel in csrc/probes.cu, and
the entry point prints one line per primitive with a sample of its result
and its time on the card.

Each wrapper picks its route by the device of its input: CUDA tensors go to
the kernel, CPU tensors to the plain PyTorch version beside it (`*_plain`),
which the tests hold to the Pallas bodies and which nothing on the card's
path calls. The probe6 wrappers check their input before the route, so that
both routes raise on the same bad input. A kernel that can find a bad input reports it in the launch
path's mapped flag word (`kernels.launch_flagged`), and the wrapper raises.
Words are u32 bit patterns in int32 tensors, as everywhere in the port.
The scripts' XLA-only parts (`hillis_cumsum`, `hillis_xor`, `hist2`) are
plain torch functions here: they make the gather's inputs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import kernels
from .device import resolve
from .ops.bitpack import pack_rows
from .ops.bitpack_cuda import check_widths, on_cuda

__all__ = [
    "broadcast_last_lane", "broadcast_last_lane_plain", "carry_into_vector",
    "carry_into_vector_plain", "carry_revisit", "carry_revisit_plain", "carry_scans",
    "carry_scans_plain", "gather", "gather_arms", "gather_cases", "gather_plain",
    "hillis_cumsum", "hillis_xor", "hist2", "main", "onehot_count", "onehot_count_plain",
    "pack_levels", "pack_levels_plain", "rmw_loop8", "rmw_loop8_plain", "roll_lane",
    "roll_lane_plain", "roll_sublane", "roll_sublane_plain", "scalar_extract",
    "scalar_extract_plain", "var_shift", "var_shift_plain", "window_rmw", "window_rmw_plain",
]

ROWS, LANES = 8, 128
TILE = ROWS * LANES  # tokens of a tile, threads of a CTA in csrc/probes.cu
WIN = 384  # the scripts' window, in words
TILE_WIN = 1280  # words of p7_pack_kernel's per-tile window
G_TILE = 1024  # idx entries a CTA of gather_kernel takes
G_STAGE_WORDS = 6144  # the widest span of S a gather tile stages in shared memory
_U32 = 0xFFFFFFFF

# the scripts' own shapes
P3_B, P3_BS = 64, 1 << 18
P6_RMW_WORDS = 1152
P7_B, P7_NT, P7_N_WORDS = 2, 3072, 1100
# Most tiles a row pack_levels takes. p7_pack_kernel's CTA re-sums the
# widths of the tiles before its own, so a row of T tiles reads T(T - 1)/2
# tiles of widths: 3 at the probe's 3 tiles, 120 (7.5 times the row) at 16.
P7_MAX_TILES = 16
P7_NWP = -(-P7_N_WORDS // 128) * 128 + WIN + 128
P8_B, P8_T, P8_NWP = 2, 3, 1664


def _i32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, not {x.dtype}")
    return x.contiguous()


# ---- probe3: hillis scans, the two-level histogram, the gather -------------------------------


def hillis_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive + scan along axis 1 by log2 shifted adds (Hillis-Steele)."""
    s = 1
    while s < x.shape[1]:
        y = x.clone()
        y[:, s:] += x[:, :-s]
        x, s = y, s * 2
    return x


def hillis_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive XOR scan along axis 1 by log2 shifted XORs."""
    s = 1
    while s < x.shape[1]:
        y = x.clone()
        y[:, s:] ^= x[:, :-s]
        x, s = y, s * 2
    return x


def hist2(nbits: torch.Tensor, n_words: int) -> torch.Tensor:
    """b[:, w] = (number of tokens whose first bit lies in a word <= w) - 1,
    for w in [0, n_words]: the index of the last such token. The script
    counted with a two-level one-hot product on the matrix unit; a scatter
    counts here."""
    B = nbits.shape[0]
    nb = nbits.to(torch.int64)
    w0 = (torch.cumsum(nb, dim=1) - nb) >> 5
    nhi = (n_words + 1 + 255) // 256
    cnt = torch.zeros((B, nhi * 256), dtype=torch.int64, device=nbits.device)
    cnt.scatter_add_(1, w0.clamp(max=nhi * 256 - 1), (w0 < nhi * 256).to(torch.int64))
    return (torch.cumsum(cnt, dim=1) - 1)[:, : n_words + 1].to(torch.int32)


def gather_plain(S: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= S.shape[1]):
        raise IndexError("gather index out of range")
    return torch.gather(S, 1, idx.to(torch.int64))


def gather_arms(S: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 [3]: the tiles of G_TILE entries of each row that gather_kernel
    takes (staged, direct, out of range), by its rule: a tile with an index
    outside [0, ns) is out of range; else it is staged when its indices span
    at most G_STAGE_WORDS words and S starts on a 16-byte bound."""
    B, ni = idx.shape
    if idx.numel() == 0:
        return torch.zeros(3, dtype=torch.int64, device=idx.device)
    T = -(-ni // G_TILE)
    x = torch.cat([idx, idx[:, -1:].expand(B, T * G_TILE - ni)], 1).reshape(B, T, G_TILE).to(torch.int64)
    mn, mx = x.amin(2), x.amax(2)
    bad = (mn < 0) | (mx >= S.shape[1])
    staged = ~bad & (mx - mn < G_STAGE_WORDS) & (S.data_ptr() % 16 == 0)
    return torch.stack([staged.sum(), (~bad & ~staged).sum(), bad.sum()])


def gather_cases(dev, seed: int = 3) -> dict:
    """name -> (S, idx): the shapes the gather is held to beside the probe's
    own (tests, chip_smoke.py). Each row holds index 0 and ns - 1."""
    rng = np.random.default_rng(seed)

    def case(B, ns, idx):
        idx[:, 0], idx[:, -1] = 0, ns - 1
        S = rng.integers(-(1 << 31), 1 << 31, (B, ns)).astype(np.int32)
        return torch.from_numpy(S).to(dev), torch.from_numpy(idx.astype(np.int32)).to(dev)

    return {
        # sorted, rising ~5 a step, then held at ns - 1 as hist2's clamp holds it: staged
        "sorted": case(3, 20011, np.minimum(np.cumsum(rng.integers(3, 7, (3, 5003)), 1), 20010)),
        # unsorted over rows wider than the staged span: direct
        "random": case(2, 300007, rng.integers(0, 300007, (2, 4099))),
        "one entry": case(1, 7, np.zeros((1, 1), np.int64)),
        # ni odd and past a tile: odd rows start misaligned
        "odd rows": case(5, 1001, rng.integers(0, 1001, (5, 6151))),
        # B * ns not a multiple of 4: the last row's window ends inside the allocation's last 16 bytes
        "ends": case(3, 4095, rng.integers(0, 4095, (3, 2053))),
        "ns below a tile": case(4, 100, rng.integers(0, 100, (4, 3000))),
    }


def gather(S: torch.Tensor, idx: torch.Tensor, arms: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, i] = S[b, idx[b, i]]; S [B, ns], idx [B, ni], int32 both.
    An index outside [0, ns) raises IndexError. arms, if given (int32 [3]
    on the inputs' device), gains the count of tiles by the arm the kernel
    took (gather_arms's rule on the CPU)."""
    if not on_cuda(S, idx):
        if arms is not None:
            arms += gather_arms(S, idx).to(arms.dtype)
        return gather_plain(S, idx)
    if S.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"expected int32 tensors, not {S.dtype}, {idx.dtype}")
    if S.dim() != 2 or idx.dim() != 2 or S.shape[0] != idx.shape[0]:
        raise ValueError(f"expected S [B, ns] and idx [B, ni], not {tuple(S.shape)}, {tuple(idx.shape)}")
    if arms is not None and (arms.dtype != torch.int32 or arms.shape != (3,) or arms.device != S.device):
        raise ValueError("arms must be an int32 [3] tensor on the inputs' device")
    S, idx = S.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    if idx.numel() == 0:
        return out
    if kernels.launch_flagged("tdc_probe3_gather", S, idx, out, S.shape[0], S.shape[1], idx.shape[1], arms):
        raise IndexError("gather index out of range")
    return out


# ---- probe6: seven primitives on one [8, 128] int32 tile ------------------------------------


def _tile_op(fn: str, plain, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32 or x.shape != (ROWS, LANES):
        raise ValueError(f"expected an int32 [{ROWS}, {LANES}] tile, not {x.dtype} {tuple(x.shape)}")
    if not on_cuda(x):
        return plain(x)
    if x.data_ptr() & 15 or not x.is_contiguous():  # the kernels read 16-byte vectors
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    kernels.launch(fn, x, out)
    return out


def roll_lane_plain(x):
    return torch.roll(x, 1, 1)


def roll_lane(x):
    """out[r, c] = x[r, c - 1], around the row."""
    return _tile_op("tdc_probe6_roll_lane", roll_lane_plain, x)


def roll_sublane_plain(x):
    return torch.roll(x, 1, 0)


def roll_sublane(x):
    """out[r, c] = x[r - 1, c], around the column."""
    return _tile_op("tdc_probe6_roll_sublane", roll_sublane_plain, x)


def scalar_extract_plain(x):
    return (x[7, 0] * 2).expand(ROWS, LANES).contiguous()


def scalar_extract(x):
    """Every element becomes 2 * x[7, 0]."""
    return _tile_op("tdc_probe6_extract", scalar_extract_plain, x)


def broadcast_last_lane_plain(x):
    return x[:, LANES - 1 :].expand(ROWS, LANES).contiguous()


def broadcast_last_lane(x):
    """Every row becomes its last lane."""
    return _tile_op("tdc_probe6_bid", broadcast_last_lane_plain, x)


def onehot_count_plain(x):
    w0a = torch.remainder(x, WIN)
    onehot = (w0a[:, None, :] == torch.arange(WIN, device=x.device)[None, :, None]).to(torch.float32)
    planes = torch.ones((ROWS, LANES, 8), dtype=torch.float32, device=x.device)
    return torch.bmm(onehot, planes)[:, :LANES, 0].to(torch.int32)


def onehot_count(x):
    """out[r, j] = number of lanes l with x[r, l] mod 384 == j, for j < 128."""
    return _tile_op("tdc_probe6_dot3", onehot_count_plain, x)


def var_shift_plain(x):
    v = x.to(torch.int64) & _U32
    s = torch.remainder(x, 31).to(torch.int64)
    r = ((v << s) | (v >> (31 - s))) & _U32
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)


def var_shift(x):
    """(v << s) | (v >> (31 - s)) on the u32 pattern v of x, with s = x mod 31."""
    return _tile_op("tdc_probe6_shift", var_shift_plain, x)


def window_rmw_plain(i: torch.Tensor, n_words: int = P6_RMW_WORDS) -> torch.Tensor:
    out = torch.zeros((1, 1, n_words), dtype=torch.int32, device=i.device)
    a = (int(i.reshape(-1)[0]) >> 7) * 128
    if a < 0 or a + WIN > n_words:
        raise IndexError("window outside the row")
    out[0, 0, a : a + WIN] ^= 7
    return out


def window_rmw(i: torch.Tensor, n_words: int = P6_RMW_WORDS) -> torch.Tensor:
    """A zeroed [1, 1, n_words] row with words [a, a + 384) XORed with 7,
    a = (i >> 7) * 128 read from the first element of the int32 tensor i.
    A window outside the row raises IndexError; an empty i and a row of
    fewer than 384 words, which no window fits, raise it before a launch."""
    if i.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, not {i.dtype}")
    if i.numel() == 0:
        raise IndexError("i is empty: no window start")
    if n_words < WIN:
        raise IndexError("window outside the row")
    if not on_cuda(i):
        return window_rmw_plain(i, n_words)
    i = i.reshape(-1)[:1].contiguous()
    out = torch.empty((1, 1, n_words), dtype=torch.int32, device=i.device)
    if kernels.launch_flagged("tdc_probe6_rmw", i, out, n_words):
        raise IndexError("window outside the row")
    return out


# ---- probe7: the pack kernel in five levels ------------------------------------------------


def _check_tokens(vals, nbits):
    if vals.dim() != 2 or vals.shape != nbits.shape or vals.shape[1] % TILE:
        raise ValueError(f"expected [B, NT] tokens with NT a multiple of {TILE}, not {tuple(vals.shape)}")
    if vals.shape[1] > P7_MAX_TILES * TILE:
        raise ValueError(f"more than {P7_MAX_TILES} tiles a row: {vals.shape[1]} tokens")


def pack_levels_plain(vals, nbits, n_wp: int, level: int, want_mid: bool = False):
    """Plain version of pack_levels; mid as p7_pack_kernel lays it out."""
    _check_tokens(vals, nbits)
    check_widths(nbits)
    B, NT = nbits.shape
    dev = nbits.device
    nb = nbits.to(torch.int64)
    bits = nb.sum(1).to(torch.int32).reshape(B, 1, 1)
    if level >= 5:
        words = pack_rows(vals, nbits, n_wp)[0]
    else:
        words = torch.zeros((B, n_wp), dtype=torch.int32, device=dev)
    words = words.reshape(B, 1, n_wp)
    if not want_mid or level in (1, 5):
        return (words, bits, None) if want_mid else (words, bits)

    one = torch.ones((), dtype=torch.int64, device=dev)
    mask = torch.where(nb >= 32, _U32, torch.bitwise_left_shift(one, nb.clamp(0, 31)) - 1)
    vm = vals.to(torch.int64) & _U32 & mask
    off = torch.cumsum(nb, dim=1) - nb
    sh_end = (off & 31) + nb
    hi = torch.where(sh_end <= 32, vm << (32 - sh_end).clamp(min=0), vm >> (sh_end - 32).clamp(min=0))
    lo = torch.where(sh_end > 32, (vm << (64 - sh_end).clamp(0, 63)) & _U32, 0)
    hi = torch.where(nb > 0, hi, 0)
    lo = torch.where(nb > 0, lo, 0)
    w0 = off >> 5
    if level == 2:
        return words, bits, torch.stack([hi, lo], dim=2).to(torch.int32)

    # runs of one target word within a warp of 32 tokens; the last token of a
    # run holds the XOR (here: the sum, the parts being bit-disjoint) of its hi
    lane = torch.arange(NT, device=dev) % 32
    head = torch.ones((B, NT), dtype=torch.bool, device=dev)
    head[:, 1:] = (w0[:, 1:] != w0[:, :-1]) | (lane[1:] == 0)
    last = torch.ones((B, NT), dtype=torch.bool, device=dev)
    last[:, :-1] = head[:, 1:]
    run = torch.cumsum(head.reshape(-1).to(torch.int64), 0) - 1
    sums = torch.zeros(int(run[-1]) + 1, dtype=torch.int64, device=dev)
    sums.scatter_add_(0, run, hi.reshape(-1))
    hi_c = torch.where(last, sums[run].reshape(B, NT), 0)
    lo_c = torch.where(last, lo, 0)
    if level == 3:
        return words, bits, torch.stack([hi_c, lo_c], dim=2).to(torch.int32)

    T = NT // TILE
    tile = torch.arange(NT, device=dev) // TILE
    c0 = off.reshape(B, T, TILE)[:, :, 0]  # the carry each tile starts from
    abase = ((c0 >> 5) >> 7) << 7
    rel = w0 - abase[:, tile]
    win = torch.zeros((B, T, TILE_WIN + 1), dtype=torch.int64, device=dev)
    flat = win.reshape(B, -1)
    flat.scatter_add_(1, tile * (TILE_WIN + 1) + rel, hi_c)
    flat.scatter_add_(1, tile * (TILE_WIN + 1) + rel + 1, lo_c)
    return words, bits, win[:, :, :TILE_WIN].to(torch.int32)


def pack_levels(vals, nbits, n_wp: int, level: int, want_mid: bool = False):
    """The pack kernel at `level` (1-5) on [B, NT] (value, width <= 32)
    tokens: (words [B, 1, n_wp] int32, bits [B, 1, 1] int32). Only level 5
    fills the arena (bit-equal to ops/bitpack.pack_rows and kernel A); bits
    is the sum of the widths at every level. With want_mid a third result
    holds what levels 2-4 computed and the script threw away (None at
    levels 1 and 5). On the card a CTA takes one tile of a row, every tile
    at once (csrc/probes.cu:p7_pack_kernel), and int32 contiguous tokens go
    to the kernel as they are."""
    if level not in (1, 2, 3, 4, 5):
        raise ValueError(f"level {level} outside 1..5")
    if not on_cuda(vals, nbits):
        return pack_levels_plain(vals, nbits, n_wp, level, want_mid)
    _check_tokens(vals, nbits)
    B, NT = nbits.shape
    dev = nbits.device
    if vals.dtype != torch.int32 or not vals.is_contiguous():
        vals = vals.to(torch.int32).contiguous()
    if nbits.dtype != torch.int32 or not nbits.is_contiguous():
        nbits = _i32(nbits)
    # two allocations take less host time than one with two views
    words = torch.empty((B, 1, n_wp), dtype=torch.int32, device=dev)
    bits = torch.empty((B, 1, 1), dtype=torch.int32, device=dev)
    mid = None
    if want_mid and level in (2, 3):
        mid = torch.empty((B, NT, 2), dtype=torch.int32, device=dev)
    elif want_mid and level == 4:
        mid = torch.empty((B, NT // TILE, TILE_WIN), dtype=torch.int32, device=dev)
    if kernels.launch_flagged("tdc_probe7_pack", vals, nbits, B, NT, n_wp, words, bits, level, mid):
        raise ValueError("token width outside [0, 32]")
    return (words, bits, mid) if want_mid else (words, bits)


# ---- probe8: the pack kernel's infrastructure in four steps ---------------------------------


# On empty inputs the four agree, kernels and plain versions: T = 0 gives a
# zeroed arena and carry 0, as if the grid had run its first step alone;
# B = 0 gives empty tensors, and the wrapper launches nothing.


def _tiles_op(fn: str, plain, v: torch.Tensor, n_wp: int):
    if not on_cuda(v):
        return plain(v, n_wp)
    v = _i32(v)
    if v.dim() != 4 or tuple(v.shape[2:]) != (ROWS, LANES):
        raise ValueError(f"expected [B, T, 8, 128], not {tuple(v.shape)}")
    B, T = v.shape[:2]
    words = torch.empty((B, 1, n_wp), dtype=torch.int32, device=v.device)
    carry = torch.empty(B, dtype=torch.int32, device=v.device)
    if B > 0:
        kernels.launch(fn, v, B, T, n_wp, words, carry)
    return words, carry


def _zero_words(v, n_wp):
    return torch.zeros((v.shape[0], 1, n_wp), dtype=torch.int32, device=v.device)


def _zero_carry(v):
    return torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)


def carry_revisit_plain(v, n_wp: int = P8_NWP):
    return _zero_words(v, n_wp), v[:, :, 0, 0].sum(1).to(torch.int32)


def carry_revisit(v, n_wp: int = P8_NWP):
    """k_a: a zeroed arena; the carry sums v[b, t, 0, 0] over the tiles.
    Returns (words [B, 1, n_wp], carry [B]); the script kept the carry."""
    return _tiles_op("tdc_probe8_a", carry_revisit_plain, v, n_wp)


def carry_scans_plain(v, n_wp: int = P8_NWP):
    return _zero_words(v, n_wp), v.sum((1, 2, 3)).to(torch.int32)


def carry_scans(v, n_wp: int = P8_NWP):
    """k_b: a zeroed arena; the carry takes every tile's scanned total,
    which is the sum of all of v[b] (int32, wrapping)."""
    return _tiles_op("tdc_probe8_b", carry_scans_plain, v, n_wp)


def carry_into_vector_plain(v, n_wp: int = P8_NWP):
    if v.shape[1] == 0:
        return _zero_words(v, n_wp), _zero_carry(v)
    x = torch.cumsum(v.to(torch.int64), dim=3)
    row7 = x[:, :, 7, LANES - 1]
    c0 = torch.cumsum(row7, dim=1) - row7
    words = _zero_words(v, n_wp)
    k = min(LANES, n_wp)
    words[:, 0, :k] = (c0[:, -1, None] + x[:, -1, 0, :])[:, :k].to(torch.int32)
    return words, row7.sum(1).to(torch.int32)


def carry_into_vector(v, n_wp: int = P8_NWP):
    """k_c: words[0:128] = carry + lane scan of row 0 of the last tile, the
    carry being the sum of row 7's totals of the tiles before."""
    return _tiles_op("tdc_probe8_c", carry_into_vector_plain, v, n_wp)


def rmw_loop8_plain(v, n_wp: int = P8_NWP):
    words = _zero_words(v, n_wp)
    a = (torch.remainder(v[:, :, :, 0].to(torch.int64) * 3, 8) >> 7) * 128
    if (int(a.max()) if a.numel() else 0) + WIN > n_wp:
        raise IndexError("window outside the row")
    for b in range(v.shape[0]):
        for t in range(v.shape[1]):
            for g in range(ROWS):
                lo = int(a[b, t, g])
                words[b, 0, lo : lo + WIN] ^= g + 1
    return words, _zero_carry(v)


def rmw_loop8(v, n_wp: int = P8_NWP):
    """k_d: per tile and row g, words[a : a + 384] ^= g + 1 with
    a = (((v[b, t, g, 0] * 3) mod 8) >> 7) * 128."""
    # (v * 3) mod 8 lies in 0..7, so a is 0 for every v: every window fits
    # exactly when n_wp >= 384, checked here; the kernel reports nothing
    if on_cuda(v) and n_wp < WIN:
        raise IndexError("window outside the row")
    return _tiles_op("tdc_probe8_d", rmw_loop8_plain, v, n_wp)


# ---- the entry point -----------------------------------------------------------------------


def _timed(fn, dev, iters: int = 20):
    """(result, ms a call): CUDA events on the card, the host clock on the CPU."""
    out = fn()  # warm: builds the kernels on first use
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / iters


def _report(name, fn, dev, iters=20):
    out, ms = _timed(fn, dev, iters)
    first = out[0] if isinstance(out, tuple) else out
    print(f"{name:24s} {ms:10.4f} ms  sample={first.reshape(-1)[:3].tolist()}", flush=True)
    return out


def probe3_inputs(dev, B: int = P3_B, bs: int = P3_BS, seed: int = 1):
    """(vals, nbits) of the script: [B, 393 + bs] widths in [1, 12], values below 4096."""
    g = torch.Generator().manual_seed(seed)
    nt = 393 + bs
    nb = torch.randint(1, 13, (B, nt), generator=g, dtype=torch.int32)
    vals = torch.randint(0, 4096, (B, nt), generator=g, dtype=torch.int32)
    return vals.to(dev), nb.to(dev)


def run_probe3(dev, B: int = P3_B, bs: int = P3_BS):
    nt = 393 + bs
    n_words = (9 * bs + 4096 + 31) // 32
    vals, nb = probe3_inputs(dev, B, bs)
    _report("hillis_cumsum", lambda: hillis_cumsum(nb)[:, -1], dev, 3)
    _report("torch.cumsum", lambda: torch.cumsum(nb, dim=1, dtype=torch.int32)[:, -1], dev, 3)
    S = _report("hillis_xorscan", lambda: hillis_xor(vals), dev, 3)
    idx = _report("hist2", lambda: hist2(nb, n_words).clamp(0, nt - 1), dev, 3)
    _report("gather", lambda: gather(S, idx), dev)


def run_probe6(dev):
    x8 = torch.arange(TILE, dtype=torch.int32, device=dev).reshape(ROWS, LANES)
    for name, fn in (
        ("roll_lane", roll_lane), ("roll_sublane", roll_sublane),
        ("scalar_extract", scalar_extract), ("broadcast_in_dim", broadcast_last_lane),
        ("onehot_batched_dot", onehot_count), ("u32_var_shift", var_shift),
    ):
        _report(name, lambda fn=fn: fn(x8), dev)
    i = torch.tensor([[300]], dtype=torch.int32, device=dev)
    _report("dyn_ds_rmw", lambda: window_rmw(i), dev)


def probe7_inputs(dev, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    nbits = torch.randint(0, 33, (P7_B, P7_NT), generator=g, dtype=torch.int32)
    vals = torch.randint(0, 1 << 31, (P7_B, P7_NT), generator=g, dtype=torch.int64).to(torch.int32)
    return vals.to(dev), nbits.to(dev)


def run_probe7(dev):
    vals, nbits = probe7_inputs(dev)
    want = nbits.sum(1).tolist()
    for level in (1, 2, 3, 4, 5):
        _, bits = _report(f"level {level}", lambda: pack_levels(vals, nbits, P7_NWP, level), dev)
        print(f"{'':24s} bits={bits.reshape(-1).tolist()} want={want}", flush=True)


def run_probe8(dev):
    v4 = torch.ones((P8_B, P8_T, ROWS, LANES), dtype=torch.int32, device=dev)
    for name, fn in (
        ("grid+scratch+when", carry_revisit), ("scan_rolls+scalar", carry_scans),
        ("carry_into_vector", carry_into_vector), ("rmw_loop8", rmw_loop8),
    ):
        _, carry = _report(name, lambda fn=fn: fn(v4), dev)
        print(f"{'':24s} carry={carry.tolist()}", flush=True)


_RUN = {"3": run_probe3, "6": run_probe6, "7": run_probe7, "8": run_probe8}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tudocomp_tpu_torch.probes", description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", choices=[*_RUN, []], help="which probes to run (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {name}", flush=True)
    for p in args.probes or sorted(_RUN):
        print(f"probe {p}", flush=True)
        _RUN[p](dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
