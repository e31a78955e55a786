"""Kernel D: batched canonical Huffman decode of encode(huff) payloads.

`parse_payload_tables` reads a payload's header on the host (numpy) into
the decision tables of the canonical first-match rule; `decode_payloads`
(kernel D, csrc/decode.cu) decodes any number of streams at once, one CTA
per stream and one thread per chunk of its bits (self-synchronising
chunks through a shared-memory decode table), writing bytes straight into
an [n, max_out] arena. It replaces
tudocomp_tpu/ops/huffman_decode_pallas.py's bit-serial lockstep kernel
together with the pack kernel that compacted its output.

The rule, per stream (coders/huffman.py:246-254, HuffmanCoder.hpp:584-613):
a code of length l with value acc is complete when acc >= fc[l]; its
symbol is syms[clamp(acc + adj[l], 0, 255)]. Degenerate streams (flag 0)
are the length-8 identity code: raw 8-bit literals.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..coders.huffman import read_table
from ..io.bitio import BitReader
from .bitpack_cuda import on_cuda

__all__ = [
    "decode_payloads",
    "decode_payloads_batched",
    "decode_payloads_plain",
    "parse_payload_tables",
]

_INF = 2**31 - 1
_BATCH_BYTES = 1 << 28  # output arena per decode launch


def parse_payload_tables(payload: bytes):
    """Host-side header parse -> (fc [33] int32, adj [33] int32, syms [256]
    uint8, words uint32 [...], total_bits).

    fc[l] is the smallest l-bit codeword value that completes (2^31 - 1
    where none does); adj[l] = psl[l] - fc[l], so the rank of a complete
    code is acc + adj[l]; syms maps rank -> symbol. words holds the symbol
    bits shifted down to bit 0, as MSB-first u32 words, and total_bits
    counts them."""
    r = BitReader(payload)
    fc = np.full(33, _INF, np.int32)
    adj = np.zeros(33, np.int32)
    syms = np.arange(256, dtype=np.uint8)
    if r.read_bit():
        t = read_table(r)
        psl = np.zeros(t.longest, dtype=np.int64)
        psl[t.ordered_codelengths[0] - 1] = 0
        for i in range(1, t.alphabet_size):
            if t.ordered_codelengths[i - 1] < t.ordered_codelengths[i]:
                psl[t.ordered_codelengths[i] - 1] = i
        for l in range(1, int(t.longest) + 1):
            fc[l] = np.int32(t.firstcodes[l - 1])
            adj[l] = np.int32(psl[l - 1] - int(t.firstcodes[l - 1]))
        syms = np.zeros(256, np.uint8)
        syms[: t.alphabet_size] = t.ordered_map_from_effective
    else:
        # degenerate: raw 8-bit literals == canonical len-8 identity code
        fc[8] = 0
        adj[8] = 0

    hdr_bits = r.pos
    total_bits = max(0, r._valid - hdr_bits)
    # shift the symbol region down to bit 0 and view as MSB-first u32 words
    data = np.frombuffer(payload, np.uint8)
    byte0, sh = hdr_bits >> 3, hdr_bits & 7
    a = data[byte0:].astype(np.uint16)
    if sh:
        nxt = np.concatenate([a[1:], np.zeros(1, np.uint16)])
        a = ((a << sh) | (nxt >> (8 - sh))) & 0xFF
    a = a.astype(np.uint8)
    pad = (-len(a)) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    words = a.view(">u4").astype(np.uint32)
    return fc, adj, syms, words, total_bits


def _check_counts(counts: torch.Tensor, max_out: int) -> None:
    if counts.numel() == 0:
        return
    lo, hi = int(counts.min()), int(counts.max())
    if lo < 0:
        raise ValueError("corrupt stream: no code of 32 bits or fewer completes")
    if hi > max_out:
        raise ValueError(f"stream decodes to {hi} bytes, more than max_out={max_out}")


def decode_payloads_plain(words, total_bits, fc, adj, syms, max_out: int):
    """Plain version of decode_payloads: every stream advances one code
    per step, in lockstep."""
    n, W = words.shape
    dev = words.device
    w = torch.cat([words.to(torch.int64) & 0xFFFFFFFF, torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1)
    tb = total_bits.to(torch.int64)
    fc = fc.to(torch.int64)[:, 1:]  # [n, 32], slot l-1 for length l
    adj = adj.to(torch.int64)
    syms = syms.to(torch.int64)
    lens = torch.arange(1, 33, device=dev)
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    live = pos < tb
    rows = torch.arange(n, device=dev)
    while bool(live.any()):
        wi = (pos >> 5).clamp(max=W)
        two = (w.gather(1, wi[:, None])[:, 0] << 32) | w.gather(1, wi[:, None] + 1)[:, 0]
        peek = (two >> (32 - (pos & 31))) & 0xFFFFFFFF
        code = peek[:, None] >> (32 - lens)[None, :]  # [n, 32]: value of the first l bits
        fits = lens[None, :] <= (tb - pos)[:, None]
        hit = fits & (code >= fc)
        done = hit.any(dim=1)
        l = torch.argmax(hit.to(torch.int8), dim=1) + 1  # shortest complete length
        bad = live & ~done & ((tb - pos) >= 32)
        if bool(bad.any()):
            cnt = torch.where(bad, -1, cnt)
        step = live & done
        c = code.gather(1, (l - 1)[:, None])[:, 0]
        r = (c + adj.gather(1, l[:, None])[:, 0]).clamp(0, 255)
        sym = syms.gather(1, r[:, None])[:, 0]
        put = step & (cnt < max_out) & (cnt >= 0)
        out[rows[put], cnt[put]] = sym[put].to(torch.uint8)
        cnt = torch.where(step & (cnt >= 0), cnt + 1, cnt)
        pos = torch.where(step, pos + l, pos)
        live = step & (pos < tb)
    return out, cnt


def decode_payloads(words, total_bits, fc, adj, syms, max_out: int, sync_rounds: bool = False):
    """Decode n streams: words [n, W] (u32 bit patterns in int32, symbol bits
    from bit 0), total_bits [n], fc / adj [n, 33] int32, syms [n, 256] uint8
    -> (out [n, max_out] uint8, counts [n] int64). Row i holds stream i's
    counts[i] bytes; a stream that decodes past max_out, or needs a code
    longer than 32 bits, raises. With sync_rounds a third tensor follows:
    the kernel's synchronisation rounds for each stream, [n] int32 (None on
    the CPU, where the plain version runs)."""
    args = (words, total_bits, fc, adj, syms)
    if not on_cuda(*args):
        out, counts = decode_payloads_plain(*args, max_out)
        _check_counts(counts, max_out)
        return (out, counts, None) if sync_rounds else (out, counts)
    n, W = words.shape
    dev = words.device
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)  # as the plain version's
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    rounds = torch.zeros(n, dtype=torch.int32, device=dev) if sync_rounds else None
    if n:
        kernels.launch(
            "tdc_decode_payloads",
            words.to(torch.int32).contiguous(), W, total_bits.to(torch.int32).contiguous(),
            fc.to(torch.int32).contiguous(), adj.to(torch.int32).contiguous(),
            syms.to(torch.uint8).contiguous(), n, out, max_out, counts, rounds,
        )
        _check_counts(counts, max_out)
    return (out, counts, rounds) if sync_rounds else (out, counts)


def decode_payloads_batched(payloads: list, max_out: int, device) -> list:
    """Decode any number of encode(huff) payloads on `device` -> their bytes."""
    parsed = [parse_payload_tables(p) for p in payloads]
    per = max(1, _BATCH_BYTES // max(1, max_out))
    out = []
    for lo in range(0, len(parsed), per):
        part = parsed[lo : lo + per]
        n = len(part)
        W = max(max(len(p[3]) for p in part), 1)
        words = np.zeros((n, W), np.uint32)
        for i, p in enumerate(part):
            words[i, : len(p[3])] = p[3]

        def stack(k, dtype):
            return torch.from_numpy(np.stack([p[k] for p in part]).astype(dtype)).to(device)

        arena, counts = decode_payloads(
            torch.from_numpy(words.view(np.int32)).to(device),
            torch.tensor([p[4] for p in part], dtype=torch.int32, device=device),
            stack(0, np.int32), stack(1, np.int32), stack(2, np.uint8), max_out,
        )
        arena = arena.cpu().numpy()
        out.extend(arena[i, :c].tobytes() for i, c in enumerate(counts.tolist()))
    return out
