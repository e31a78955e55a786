"""Inputs shared by the port's CPU tests and its card tests (no JAX here).

Kernel D: one Huffman stream per case, as the tables and words
parse_payload_tables gives (or made by hand where a payload cannot say it),
with the bytes it must decode to. Kernel H: sentinel-terminated texts.
"""

import numpy as np

from tudocomp_tpu_torch.driver import compress
from tudocomp_tpu_torch.io.bitio import BitWriter
from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd

INF = 2**31 - 1
WORDS = [b"the ", b"card ", b"decodes ", b"chunks ", b"of ", b"bits, ", b"in ", b"rounds. "]

DECODE_CASES = [
    "zipf", "english", "random", "identity", "all-8", "all-5", "fibonacci", "tail-4",
    "false-invalid", "over-32", "over-max_out",
]
# payloads the JAX package can decode too (the others have hand-made tables,
# a dropped tail it cannot be told of, or an error it does not report)
JAX_DECODE_CASES = ["zipf", "english", "random", "identity", "all-8", "all-5", "fibonacci"]


def english(n: int, seed: int = 11) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(rng.choice(WORDS, n // 3 + 1))[:n]


def _fibonacci_bytes() -> bytes:
    """Fibonacci counts, shuffled: 10945 symbols, codes of 1 to 18 bits."""
    fib = [1, 1]
    while len(fib) < 19:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(4)
    return bytes(rng.permutation(np.repeat(np.arange(19, dtype=np.uint8), fib)))


def _words(bits) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)
    bits = np.concatenate([bits, np.zeros((-len(bits)) % 32, np.uint8)])
    return np.packbits(bits).view(">u4").astype(np.uint32)


def _incomplete_table():
    """Codes '1x' -> a, b (2 bits), '01x' -> c, d (3 bits); a stream at '00'
    has no code of 32 bits or fewer."""
    fc = np.full(33, INF, np.int32)
    adj = np.zeros(33, np.int32)
    fc[2], fc[3] = 2, 2
    adj[2], adj[3] = -2, 0
    syms = np.zeros(256, np.uint8)
    syms[:4] = np.frombuffer(b"abcd", np.uint8)
    return fc, adj, syms


_INCOMPLETE_CODES = {b"a"[0]: [1, 0], b"b"[0]: [1, 1], b"c"[0]: [0, 1, 0], b"d"[0]: [0, 1, 1]}


def _incomplete_bits(data: bytes) -> list:
    return [b for s in data for b in _INCOMPLETE_CODES[s]]


def decode_case(name: str) -> dict:
    """{"stream": (fc, adj, syms, words, total_bits), "max_out", "data",
    "payload"}: data is what the stream decodes to (None: it is invalid or
    too long for max_out), payload its encode(huff) bytes where it has them."""
    payload = data = None
    if name in ("zipf", "english", "random", "identity", "all-8", "all-5", "fibonacci", "over-max_out"):
        rng = np.random.default_rng(DECODE_CASES.index(name))
        data = {
            "zipf": lambda: bytes(rng.zipf(1.3, 2600).clip(0, 255).astype(np.uint8)),
            "english": lambda: english(2400),
            "random": lambda: bytes(rng.integers(0, 256, 1400).astype(np.uint8)),
            "identity": lambda: b"z" * 1500,  # one symbol: the degenerate identity code
            "all-8": lambda: bytes(rng.permutation(np.tile(np.arange(256, dtype=np.uint8), 6))),
            "all-5": lambda: bytes(rng.permutation(np.tile(np.arange(32, dtype=np.uint8) + 64, 60))),
            "fibonacci": _fibonacci_bytes,
            "over-max_out": lambda: bytes(rng.zipf(1.3, 2000).clip(0, 255).astype(np.uint8)),
        }[name]()
        payload = compress("encode(huff)", data, device="cpu", raw=True)
        stream = hd.parse_payload_tables(payload)
    elif name == "tail-4":  # the identity code and 4 bits more: the tail is dropped
        data = english(700, seed=5)
        w = BitWriter()
        w.write_bit(0)
        for b in data:
            w.write_int(b, 8)
        w.write_int(0b1011, 4)
        payload = w.getvalue()
        stream = hd.parse_payload_tables(payload)
        assert stream[4] == 8 * len(data) + 4
    else:  # hand-made tables of an incomplete code
        fc, adj, syms = _incomplete_table()
        rng = np.random.default_rng(DECODE_CASES.index(name))
        data = bytes(rng.choice(np.frombuffer(b"abcd", np.uint8), 1200))
        bits = _incomplete_bits(data)
        if name == "over-32":  # 300 codes, then '000' and 40 bits more
            bits = _incomplete_bits(data[:300]) + [0, 0, 0] + [1] * 40
            data = None
        stream = (fc, adj, syms, _words(bits), len(bits))
    max_out = 16384
    if name == "over-max_out":
        max_out, data = len(data) // 2, None
    return {"stream": stream, "max_out": max_out, "data": data, "payload": payload}


def stack_streams(streams, min_words: int = 1):
    """numpy (words [n, W] int32, total_bits [n], fc, adj [n, 33], syms [n, 256])
    of parse_payload_tables-style streams; W at least min_words."""
    W = max(max(len(s[3]) for s in streams), min_words)
    words = np.zeros((len(streams), W), np.uint32)
    for i, s in enumerate(streams):
        words[i, : len(s[3])] = s[3]
    return (
        words.view(np.int32),
        np.array([s[4] for s in streams], np.int32),
        np.stack([s[0] for s in streams]).astype(np.int32),
        np.stack([s[1] for s in streams]).astype(np.int32),
        np.stack([s[2] for s in streams]).astype(np.uint8),
    )


# ---- kernel H ------------------------------------------------------------------------------

PLCP_TOP = 256  # csrc/plcp.cu: TOP, the top level's positions at most
PLCP_BOUNDARY_SIZES = [257, 258, 1025, 1026, 4097, 4098, 16385, 16386]  # n: 0 and 1 levels, 1 and 2, ...


def plcp_text(name: str) -> np.ndarray:
    """A text ending in its unique 0 sentinel."""
    if name == "n=0":
        return np.zeros(0, np.uint8)
    if name.startswith("n="):
        n = int(name[2:])
        raw = english(n - 1, seed=n)
    elif name == "a^n":
        raw = b"a" * 5000
    elif name == "period 1000":
        raw = english(1000, seed=3) * 9
    elif name == "english":
        raw = english(30000)
    elif name == "dna":
        rng = np.random.default_rng(12)
        raw = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 20000))
    else:
        raise KeyError(name)
    return np.frombuffer(raw + b"\0", np.uint8).copy()


PLCP_CASES = ["n=0", "n=1", "n=2", *(f"n={n}" for n in PLCP_BOUNDARY_SIZES), "a^n", "period 1000", "english", "dna"]
