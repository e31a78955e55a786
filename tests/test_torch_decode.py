"""Kernel D of the PyTorch port (batched Huffman decode), on the CPU, against the JAX package.

On CPU tensors decode_payloads runs its plain version. It is held to
tudocomp_tpu's bit-serial Pallas kernel in interpret mode on the payloads
of tests/test_device_ops.py (TestBitserialDecode), and the header parse to
tudocomp_tpu's parse_payload_tables. Tolerance: exact equality, since every
stage is integer arithmetic.
"""

import numpy as np
import pytest

import torch

from tudocomp_tpu.driver import compress
from tudocomp_tpu.ops import huffman_decode_pallas as jd
from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd


def _cases():
    rng = np.random.default_rng(5)
    return [
        b"bit serial lockstep decode " * 30,
        bytes(rng.integers(0, 256, 2000).astype(np.uint8)),
        b"",
        b"q",
        b"zzzzzzzzzzzz",  # degenerate single-symbol alphabet
        bytes(rng.choice(np.frombuffer(b"AC", np.uint8), 3000).tobytes()),
    ]


CASES = _cases()
PAYLOADS = [compress("encode(huff)", c, raw=True) for c in CASES]


def test_parse_payload_tables_matches_jax():
    for p in PAYLOADS:
        fc, adj, syms, words, tb = hd.parse_payload_tables(p)
        jfc, jadj, jsym4, jwords, jtb = jd.parse_payload_tables(p)
        np.testing.assert_array_equal(fc, jfc)
        np.testing.assert_array_equal(adj, jadj)
        np.testing.assert_array_equal(words, jwords)
        assert tb == jtb
        sym4 = (syms.astype(np.int64).reshape(64, 4) << (8 * np.arange(4))).sum(1).astype(np.int32)
        np.testing.assert_array_equal(sym4, jsym4)


def test_decode_matches_bitserial_kernel():
    got = hd.decode_payloads_batched(PAYLOADS, 4096, "cpu")
    want = jd.decode_payloads_bitserial(PAYLOADS, max_out=4096, interpret=True)
    assert got == want
    assert got == CASES


def test_decode_deep_codes():
    fib = [1, 1]
    while len(fib) < 19:
        fib.append(fib[-1] + fib[-2])
    data = b"".join(bytes([i]) * n for i, n in enumerate(fib))
    payload = compress("encode(huff)", data, raw=True)
    assert jd.parse_payload_tables(payload)[0][18] < 2**31 - 1  # codes of 18 bits exist
    (out,) = hd.decode_payloads_batched([payload], len(data), "cpu")
    assert out == data


def _stream(fc_len8: int, total_bits: int):
    fc = torch.full((1, 33), 2**31 - 1, dtype=torch.int32)
    fc[0, 8] = fc_len8
    return (
        torch.zeros((1, 2), dtype=torch.int32),
        torch.tensor([total_bits], dtype=torch.int32),
        fc,
        torch.zeros((1, 33), dtype=torch.int32),
        torch.arange(256, dtype=torch.uint8)[None],
    )


def test_decode_rejects_codes_longer_than_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        hd.decode_payloads(*_stream(2**31 - 1, 64), 16)


def test_decode_rejects_overflowing_output():
    with pytest.raises(ValueError, match="max_out"):
        hd.decode_payloads(*_stream(0, 64), 4)  # 8 raw bytes into 4
    out, counts = hd.decode_payloads(*_stream(0, 60), 8)  # the 4-bit tail is dropped
    assert counts.tolist() == [7]
    assert out[0, :7].tolist() == [0] * 7


# ---- kernel D's schedule (csrc/decode.cu), emulated thread by thread -------------------------
#
# The CUDA kernel cannot run here. This emulation follows its schedule step
# for step: the 2^K decode table, the gcd grid of speculative starts, each
# thread's speculative decode of its chunk, the synchronisation rounds
# (both walks side by side until they meet), the scan of the counts up to
# the first invalid chunk, and the writes. It is held to the plain version
# and to the JAX package's bit-serial kernel on the cases of
# tests/torch_cases.py, with the launch's thread count and with 1024
# threads (chunks of 32 bits, boundaries inside codes).

from tests import torch_cases as tc  # noqa: E402

K, MAX_T, CHUNK_BITS = 11, 1024, 512  # csrc/decode.cu


def _launch_threads(W: int) -> int:
    t = 32
    while t < MAX_T and t * 2 * CHUNK_BITS <= W * 32:
        t *= 2
    return t


class _EmuStream:
    def __init__(self, words, tb, fc, adj, syms):
        w = [int(x) & 0xFFFFFFFF for x in words] + [0, 0, 0]
        self.two = [(w[i] << 32) | w[i + 1] for i in range(len(w) - 1)]
        self.tb, self.fc, self.adj, self.sy = int(tb), [int(x) for x in fc], [int(x) for x in adj], list(syms)
        self.tab = []
        for v in range(1 << K):
            e = (0, 0)
            for l in range(1, K + 1):
                code = v >> (K - l)
                if code >= self.fc[l]:
                    e = (l, self.sy[min(max(code + self.adj[l], 0), 255)])
                    break
            self.tab.append(e)
        g, open_ = 0, 1
        for l in range(1, 33):
            if open_ == 0:
                break
            if self.fc[l] < 2 * open_:
                g = np.gcd(g, l)
            open_ = min(self.fc[l], 2 * open_)
        self.g = int(g) or 1

    def peek32(self, p):
        q = p >> 5
        return ((self.two[q] << (p & 31)) >> 32) & 0xFFFFFFFF if q < len(self.two) else 0

    def next_code(self, p):
        """(length, symbol); (0, None) at the dropped tail; (-1, None) invalid."""
        top = self.peek32(p)
        avail = self.tb - p
        l, sym = self.tab[top >> (32 - K)]
        if not l:
            for l in range(K + 1, 34):
                if l == 33:
                    return (-1 if avail >= 32 else 0), None
                code = top >> (32 - l)
                if code >= self.fc[l]:
                    sym = self.sy[min(max(code + self.adj[l], 0), 255)]
                    break
        return (0, None) if l > avail else (l, sym)


def _emu_chunk(s, start, end, nxt, old=None):
    """decode_chunk: (exit, n, bad) of the chunk from `start`; `old` is the
    previous decode ((start, (exit, n, bad))) the new walk merges into."""
    pn, cn = start, 0
    po, co, rec = (old[0], 0, old[1]) if old else (None, 0, None)
    old_live = old is not None and po < end
    while True:
        if pn >= end:
            return pn, cn, False
        if old_live and po == pn:
            return rec[0], rec[1] - co + cn, rec[2]
        if old_live and po < pn:
            l, _ = s.next_code(po)
            po, co = po + max(l, 0), co + 1
            old_live = l > 0 and po < end
        else:
            l, _ = s.next_code(pn)
            if l == 0:
                return s.tb, cn, False
            if l < 0:
                return nxt, cn, True
            pn, cn = pn + l, cn + 1


def emulate_kernel_d(words, total_bits, fc, adj, syms, max_out, threads=None):
    """(out [n, max_out] uint8, counts [n] int64, rounds [n]) as decode_kernel computes them."""
    n, W = words.shape
    T = threads or _launch_threads(W)
    out = np.zeros((n, max_out), np.uint8)
    counts, rounds_out = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(n):
        s = _EmuStream(words[i], total_bits[i], fc[i], adj[i], syms[i])
        tb = s.tb
        L = -(-tb // T)
        L = 32 if L < 32 else (L + 31) & ~31

        def spec(k):
            return min(-(-k * L // s.g) * s.g, tb)

        ends = [min((c + 1) * L, tb) for c in range(T)]
        starts = [0] + [spec(c) for c in range(1, T)]
        recs = [_emu_chunk(s, starts[c], ends[c], spec(c + 1)) for c in range(T)]
        rounds = 0
        while True:
            exits = [r[0] for r in recs]  # read by all before any writes
            moved = [c for c in range(1, T) if exits[c - 1] != starts[c]]
            for c in moved:
                recs[c] = _emu_chunk(s, exits[c - 1], ends[c], spec(c + 1), (starts[c], recs[c]))
                starts[c] = exits[c - 1]
            if not moved:
                break
            rounds += 1
            if rounds >= T:
                break
        bad = [c for c in range(T) if recs[c][2]]
        first_bad = bad[0] if bad else T
        ns = [recs[c][1] if c <= first_bad else 0 for c in range(T)]
        offs = np.concatenate([[0], np.cumsum(ns)[:-1]])
        counts[i] = -1 if bad else sum(ns)
        rounds_out[i] = rounds
        for c in range(T):
            p = starts[c]
            for j in range(ns[c]):
                if offs[c] + j >= max_out:
                    break
                l, sym = s.next_code(p)
                assert l > 0, (i, c, j)
                out[i, offs[c] + j] = sym
                p += l
    return out, counts, rounds_out


_D_PLAIN = {}


def _case_arrays(name):
    case = tc.decode_case(name)
    return case, tc.stack_streams([case["stream"]])


@pytest.mark.parametrize("threads", ["launch", 1024])
@pytest.mark.parametrize("name", tc.DECODE_CASES)
def test_kernel_d_schedule(name, threads):
    """The emulated schedule equals the plain version (out and counts) and,
    where the stream is valid, the bytes it encodes; fixed-length codes take
    no synchronisation round."""
    case, arrays = _case_arrays(name)
    max_out = case["max_out"]
    if name not in _D_PLAIN:
        _D_PLAIN[name] = tuple(
            t.numpy() for t in hd.decode_payloads_plain(*(torch.from_numpy(a) for a in arrays), max_out)
        )
    want_out, want_counts = _D_PLAIN[name]
    out, counts, rounds = emulate_kernel_d(*arrays, max_out, threads=None if threads == "launch" else threads)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(out, want_out)
    if case["data"] is not None:
        assert out[0, : counts[0]].tobytes() == case["data"]
    if name in ("identity", "all-8", "all-5", "tail-4"):  # one code length: starts on the grid
        assert rounds[0] == 0
    if name == "over-32":
        assert counts[0] == -1
    if name == "over-max_out":
        assert counts[0] > max_out


def test_kernel_d_chunks_split_long_codes():
    """With 1024 threads the Fibonacci stream's 32-bit chunks start inside
    codes (of up to 18 bits) and the rounds resynchronise them; the hand-made
    incomplete code meets false invalid codes on the way and still decodes."""
    for name in ("fibonacci", "false-invalid"):
        case, arrays = _case_arrays(name)
        s = _EmuStream(*(a[0] for a in (arrays[0], arrays[1], arrays[2], arrays[3], arrays[4])))
        bounds, p = set(), 0
        while p < s.tb:
            bounds.add(p)
            p += s.next_code(p)[0]
        inside = [c for c in range(1, 1024) if c * 32 < s.tb and c * 32 not in bounds]
        assert inside
        if name == "false-invalid":  # a speculative start that meets no valid code
            assert any(_emu_chunk(s, c * 32, min(c * 32 + 32, s.tb), 0)[2] for c in inside)
        out, counts, rounds = emulate_kernel_d(*arrays, case["max_out"], threads=1024)
        assert rounds[0] >= 1
        assert out[0, : counts[0]].tobytes() == case["data"]


def test_kernel_d_cases_match_bitserial_kernel():
    """The payload cases through one interpret-mode batch of the JAX
    package's bit-serial kernel, against the emulated schedule."""
    cases = [tc.decode_case(name) for name in tc.JAX_DECODE_CASES]
    want = jd.decode_payloads_bitserial([c["payload"] for c in cases], max_out=16384, interpret=True)
    for name, case, w in zip(tc.JAX_DECODE_CASES, cases, want):
        arrays = tc.stack_streams([case["stream"]])
        out, counts, _ = emulate_kernel_d(*arrays, case["max_out"])
        assert out[0, : counts[0]].tobytes() == w == case["data"], name
