"""Inputs shared by the port's CPU tests, its card tests and chip_smoke.py
(no JAX here).

Kernels A and B: the cases at the boundaries of their tile schedule.
Kernels C and G: histogram rows at the edges of the Moffat chain.
Kernel D: one Huffman stream per case, as the tables and words
parse_payload_tables gives (or made by hand where a payload cannot say it),
with the bytes it must decode to. Kernel H: sentinel-terminated texts.
Kernel J: inputs at the edges of its chunks. The probe8 kernels: tiles and
rows at the edges of their schedules.
"""

import numpy as np
import torch

from tudocomp_tpu_torch.driver import compress
from tudocomp_tpu_torch.io.bitio import BitWriter
from tudocomp_tpu_torch.ops import bitpack_cuda as bc
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


# ---- kernel F ------------------------------------------------------------------------------

LZW_CASES = ["corpus", "run", "run-ends-on-phrase", "random", "short", "english"]


def lzw_case(name: str):
    """numpy (blocks [B, bs] uint8, n_valid [B] int32) of an LZW edge case:
    "run" one byte throughout (phrases of 1, 2, 3, ... bytes, past two warps'
    64 lanes), "run-ends-on-phrase" a run of 1 + 2 + ... + 76 bytes (the
    block ends where its last phrase does) and one byte more, "random"
    uniform bytes (the table near its worst load), "short" blocks of 0, 1
    and 2 valid bytes, "english" the English stand-in."""
    rng = np.random.default_rng(LZW_CASES.index(name) + 40)
    if name == "corpus":  # the corpus of tests/test_lz78_device.py
        bs = 512
        blocks = np.zeros((6, bs), np.uint8)
        blocks[0] = rng.integers(0, 256, bs)
        blocks[1] = rng.integers(97, 100, bs)
        blocks[2] = 65
        blocks[3] = np.frombuffer((b"abracadabra " * (bs // 12 + 1))[:bs], np.uint8)
        blocks[4, : bs // 2] = rng.integers(0, 4, bs // 2)
        return blocks, np.array([bs, bs, bs, bs, bs // 2, 0], np.int32)
    if name == "run":
        return np.full((2, 3000), ord("z"), np.uint8), np.array([3000, 2999], np.int32)
    if name == "run-ends-on-phrase":
        n = 76 * 77 // 2
        return np.full((2, n + 1), ord("a"), np.uint8), np.array([n, n + 1], np.int32)
    if name == "random":
        return rng.integers(0, 256, (2, 4096)).astype(np.uint8), np.array([4096, 4095], np.int32)
    if name == "short":
        return rng.integers(0, 256, (3, 8)).astype(np.uint8), np.array([0, 1, 2], np.int32)
    if name == "english":
        return np.frombuffer(english(2 * 4096, seed=13), np.uint8).reshape(2, 4096).copy(), np.array(
            [4096, 4000], np.int32)
    raise KeyError(name)


# ---- probe7's pack kernel ------------------------------------------------------------------

P7_WIDTHS = ["0", "32", "mix", "sparse"]


def p7_tokens(nt: int, widths: str, seed: int = 0):
    """numpy (vals uint32, nbits int32) [2, nt] for the pack kernel: widths
    all 0, all 32, a mix in [0, 32] with a run of zeros, whose tile sums
    are 1 mod 32 in row 0, so that every tile of that row after the first
    starts inside a word it shares with the tile before (a boundary word in
    every tile), or sparse: in row 0 one token of 3 bits a tile (every tile
    inside word 0, the last one's walk back crossing all of them), in row 1
    a width of 1 once in 64 tokens."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 32, (2, nt), dtype=np.uint64).astype(np.uint32)
    if widths in ("0", "32"):
        return vals, np.full((2, nt), int(widths), np.int32)
    if widths == "sparse":
        nbits = np.zeros((2, nt), np.int32)
        nbits[0, 500::1024] = 3
        nbits[1] = rng.random(nt) < 1 / 64
        return vals, nbits
    nbits = rng.integers(0, 33, (2, nt)).astype(np.int32)
    nbits[1, 100:400] = 0
    tiles = nbits[0].reshape(-1, 1024)
    for row in tiles:  # the last width tunes the tile's sum to 1 mod 32
        row[-1] = 0
        row[-1] = (1 - row.sum()) % 32
    return vals, nbits


# ---- probe6's tile and window ---------------------------------------------------------------

# (i, n_words) that window_rmw and its plain version reject with IndexError: a window
# before the row, past its end (896 is the first i whose window ends past word 1152),
# int32's ends (at 2^31 - 1, a = 2^31 - 128 and a + 384 passes 2^31) and a row that no
# window fits
P6_RMW_BAD = [(-1, 1152), (896, 1152), (1152, 1152), ((1 << 31) - 1, 1152), (-(1 << 31), 1152), (0, 383)]

# int32's ends, -1, 0, and values around multiples of 31 (s = x mod 31 at 0 and 30), near the ends too
P6_EXTREMES = np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 1, 30, 31, 32, -30, -31, -32, 62, 2147483646,
                        2147483645, -2147483646, -2147483647], np.int64).astype(np.int32)


def p6_cases(device="cpu", seed: int = 6) -> dict:
    """name -> (probes wrapper name, args) for the redesigned probe6
    kernels, each to be held to its plain version (the wrapper's name +
    "_plain"): window_rmw at every window start the tests hold to the
    Pallas body, the last window that fits, rows whose length is not a
    multiple of 4 (the tail stored by scalars), a row past one CTA, i with
    more than one element and not contiguous (its first element counts);
    var_shift on the probe's arange, signed and extreme values, and on
    tiles one word off a 16-byte bound and transposed (the wrapper copies
    both into an aligned tile); broadcast_last_lane and onehot_count on
    those three tiles and four more (below), each also off a bound and
    transposed; scalar_extract on the three tiles and on four random tiles
    whose x[7, 0] is -2^31, 2^31 - 1, 2^30 or -2^30 - 1 (each doubled word
    wraps in int32), each also off a bound and transposed (the
    transposed tile holds x[7, 0] at word 7, not 896)."""
    rng = np.random.default_rng(seed)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    cases = {f"window_rmw i {i}": ("window_rmw", (i32([[i]]), 1152)) for i in (0, 127, 300, 767, 895)}
    for i, n in ((0, 384), (127, 385), (300, 1155), (895, 1153), (1000, 1386), (4600, 5001)):
        cases[f"window_rmw i {i}, n_words {n}"] = ("window_rmw", (i32([[i]]), n))
    cases["window_rmw i [3], first 700"] = ("window_rmw", (i32([700, 5, 1 << 20]), 1152))
    cases["window_rmw i a column, not contiguous"] = ("window_rmw", (i32([[640, 5]]).t(), 1152))

    def tile(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    def off_a_bound(a):  # the tile's values one word past a 16-byte bound
        off = torch.empty(8 * 128 + 1, dtype=torch.int32, device=device)[1:]
        off.copy_(tile(a).reshape(-1))
        return off.view(8, 128)

    def transposed(a):  # the tile's values, column-major
        return tile(a).t().contiguous().t()

    arange = np.arange(1024).reshape(8, 128)
    signed = rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32)
    extremes = rng.choice(P6_EXTREMES, (8, 128))
    cases["var_shift arange"] = ("var_shift", (tile(arange),))
    cases["var_shift signed"] = ("var_shift", (tile(signed),))
    cases["var_shift extremes"] = ("var_shift", (tile(extremes),))
    cases["var_shift one word off a bound"] = ("var_shift", (off_a_bound(signed),))
    cases["var_shift transposed"] = ("var_shift", (transposed(signed),))
    # broadcast_last_lane and onehot_count: the tiles above, one value over the whole tile
    # (one bin of each row counts 128), values whose mods 384 all lie in [128, 384) (every
    # count 0), negatives in [-384, -257] (mods 0 .. 127), and a lane's four values equal
    # (one lane adds to one bin four times); each also off a bound and transposed
    tiles = {
        "arange": arange,
        "signed": signed,
        "extremes": extremes,
        "one value": np.full((8, 128), 5),
        "mods at or above 128": rng.integers(128, 384, (8, 128)) + 384 * rng.integers(-5_000_000, 5_000_000, (8, 128)),
        "negatives -384 .. -257": rng.integers(-384, -256, (8, 128)),
        "four equal a lane": np.repeat(rng.integers(-384, 128, (8, 32)), 4, axis=1),
    }
    for fn in ("broadcast_last_lane", "onehot_count"):
        for name, a in tiles.items():
            cases[f"{fn} {name}"] = (fn, (tile(a),))
            cases[f"{fn} {name}, one word off a bound"] = (fn, (off_a_bound(a),))
            cases[f"{fn} {name}, transposed"] = (fn, (transposed(a),))
    # scalar_extract: the first three tiles, and x[7, 0] at int32's ends and just past half of
    # them, where 2 * x[7, 0] wraps to 0, -2, -2^31 and 2^31 - 2
    ends = {}
    for v in (-(1 << 31), (1 << 31) - 1, 1 << 30, -(1 << 30) - 1):
        a = rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32)
        a[7, 0] = v
        ends[f"x[7, 0] = {v}"] = a
    for name, a in {**{k: tiles[k] for k in ("arange", "signed", "extremes")}, **ends}.items():
        cases[f"scalar_extract {name}"] = ("scalar_extract", (tile(a),))
        cases[f"scalar_extract {name}, one word off a bound"] = ("scalar_extract", (off_a_bound(a),))
        cases[f"scalar_extract {name}, transposed"] = ("scalar_extract", (transposed(a),))
    return cases


# ---- probe8's tile steps ---------------------------------------------------------------------

# int32's ends, -1, 0 and the values around +-2^31 / 3, where v * 3 wraps
P8_EXTREMES = np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 715827882, 715827883, -715827882, -715827883,
                        -715827884, 715827881], np.int64).astype(np.int32)


def p8_cases(device="cpu", seed: int = 8) -> dict:
    """name -> (v [B, T, 8, 128] int32, n_wp) for the probe8 kernels: the
    probe's shape of ones, random and extreme values, one tile, more tiles
    than k_c's warps (31) and more windows than k_d stages at once (2048),
    rows narrower than k_c's 128 lanes (k_d raises there), of exactly one
    window, of lengths whose rows start off a 16-byte bound (one of them
    wider than k_c's zeroing CTA), v itself off a 16-byte bound, and the
    empty inputs: no row (B = 0: empty outputs, no launch) and rows of no
    tile (T = 0: a zeroed arena, carry 0)."""
    rng = np.random.default_rng(seed)

    def rand(B, T, lo=0, hi=33):
        return rng.integers(lo, hi, (B, T, 8, 128)).astype(np.int32)

    cases = {
        "ones": (np.ones((2, 3, 8, 128), np.int32), 1664),
        "random": (rand(5, 4), 1664),
        "random int32": (rand(2, 3, -(1 << 31), 1 << 31), 1664),
        "extremes": (rng.choice(P8_EXTREMES, (2, 3, 8, 128)), 1664),
        "T = 1": (rand(3, 1), 1664),
        "T = 9": (rand(2, 9), 1664),
        "T = 40": (rand(2, 40, -(1 << 31), 1 << 31), 1664),
        "T = 300": (rand(1, 300), 1664),
        "n_wp 100": (rand(2, 3), 100),
        "n_wp 384": (rand(2, 3), 384),
        "n_wp 1667": (rand(5, 3), 1667),
        "n_wp 5001": (rand(3, 2, -(1 << 31), 1 << 31), 5001),
    }
    out = {name: (torch.from_numpy(v).to(device), n_wp) for name, (v, n_wp) in cases.items()}
    v = torch.from_numpy(rand(2, 3, -(1 << 31), 1 << 31).reshape(-1)).to(device)
    off = torch.empty(v.numel() + 1, dtype=torch.int32, device=device)[1:]
    off.copy_(v)
    out["v off a bound"] = (off.view(2, 3, 8, 128), 1664)
    out["B = 0"] = (torch.zeros((0, 3, 8, 128), dtype=torch.int32, device=device), 1664)
    out["T = 0"] = (torch.zeros((2, 0, 8, 128), dtype=torch.int32, device=device), 1664)
    return out


def _tune_tiles(nbits: np.ndarray, residue: int, tile: int) -> None:
    """Set the last width of every whole tile of each row (to 1-32) so that
    the tile's widths sum to `residue` mod 32."""
    for row in nbits:
        for t in range(len(row) // tile):
            last = t * tile + tile - 1
            row[last] = (residue - int(row[t * tile: last].sum()) - 1) % 32 + 1


def pack_edge_cases(tile: int = bc.TILE_A) -> dict:
    """Kernel A's (csrc/pack.cu) tile-boundary cases at `tile` tokens a CTA:
    name -> (values uint32 [B, NT], nbits int32 [B, NT], n_words), numpy."""
    rng = np.random.default_rng(90)

    def vals(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)

    cases = {}
    nt = 3 * tile + 100
    nb = rng.integers(1, 33, (2, nt)).astype(np.int32)
    _tune_tiles(nb[:1], 17, tile)  # row 0: every tile boundary cuts a word
    _tune_tiles(nb[1:], 0, tile)  # row 1: every tile ends on a word boundary
    cases["boundary-words"] = (vals((2, nt)), nb, int(nb.sum(1).max()) // 32 + 5)
    cases["32-bit"] = (vals((2, 2 * tile + 5)), np.full((2, 2 * tile + 5), 32, np.int32), 2 * tile + 9)
    nb = rng.integers(0, 9, (3, nt)).astype(np.int32)
    nb[0, tile - 700: 2 * tile + 300] = 0  # a zero run over all of tile 1
    nb[1, : 2 * tile + 1] = 0  # two leading tiles without bits
    nb[2] = 0
    nb[2, 500::tile] = 3  # one token of 3 bits a tile: every tile inside word 0 or 1
    cases["zero-runs"] = (vals((3, nt)), nb, int(nb.sum(1).max()) // 32 + 5)
    nb = rng.integers(1, 33, (2, nt)).astype(np.int32)
    _tune_tiles(nb, 17, tile)
    cut = int(nb[0, :tile].sum()) >> 5  # the word that tile 1 of row 0 starts in
    cases["drop-at-boundary"] = (vals((2, nt)), nb, cut)
    cases["drop-past-boundary"] = (vals((2, nt)), nb, cut + 1)
    cases["all-zero"] = (vals((2, nt)), np.zeros((2, nt), np.int32), 40)
    nb = rng.integers(0, 33, (3, tile + 3)).astype(np.int32)  # odd rows: unaligned loads and stores
    cases["ragged"] = (vals((3, tile + 3)), nb, int(nb.sum(1).max()) // 32 + 7)
    nb = rng.integers(0, 9, (4, 393)).astype(np.int32)  # the Huffman header's shape, one tile a row
    nb[3] = 0
    cases["header-rows"] = (vals((4, 393)), nb, 393)
    return cases


def pack_bytes_edge_cases(tile: int = bc.TILE_B) -> dict:
    """Kernel B's tile-boundary cases at `tile` bytes a CTA: name ->
    (blocks uint8 [B, bs], n_valid int32 [B], table_vals uint32 [R, 256],
    table_bits int32 [R, 256], hdr_words uint32 [R, H], hdr_bits int32 [R],
    n_words), numpy; R is B, or 1 for one table and header shared by every
    row (pass them expanded to B rows)."""
    rng = np.random.default_rng(91)
    bs = 3 * tile + 50

    def tables(rows, lo=1, hi=13):
        return (rng.integers(0, 1 << 32, (rows, 256), dtype=np.uint64).astype(np.uint32),
                rng.integers(lo, hi, (rows, 256)).astype(np.int32))

    def header(bits, cols=12):
        bits = np.asarray(bits, np.int32)
        w = rng.integers(0, 1 << 32, (len(bits), cols), dtype=np.uint64).astype(np.uint32)
        for r, n in enumerate(bits.tolist()):  # the bits past the header are zero
            w[r, n // 32 + 1:] = 0
            if n % 32:
                w[r, n // 32] &= np.uint32((0xFFFFFFFF << (32 - n % 32)) & 0xFFFFFFFF)
            else:
                w[r, n // 32:] = 0
        return w, bits

    def blocks(rows):
        return rng.integers(0, 256, (rows, bs)).astype(np.uint8)

    def n_words(tv, tb, blk, nv, hb):
        return int(max(hb[r % len(hb)] + tb[r % len(tb)][blk[r, : nv[r]]].sum() for r in range(len(blk)))) // 32 + 5

    cases = {}
    full = np.full(4, bs, np.int32)
    for name, hbits in (("header-mid-word", [70, 33, 95, 1]), ("header-word-boundary", [64, 0, 32, 352])):
        blk, (tv, tb), (hw, hb) = blocks(4), tables(4), header(hbits)
        cases[name] = (blk, full, tv, tb, hw, hb, n_words(tv, tb, blk, full, hb))
    blk, (tv, tb), (hw, hb) = blocks(4), tables(4), header([70, 64, 5, 0])
    nv = np.array([bs, tile + 1000, 0, 5], np.int32)  # n_valid mid-tile, at 0, in word 0
    cases["n-valid"] = (blk, nv, tv, tb, hw, hb, n_words(tv, tb, blk, nv, hb))
    blk, (tv, tb), (hw, hb) = blocks(3), tables(3), header([1, 1, 70])
    blk[0] = 7
    tv[:2] = np.arange(256, dtype=np.uint32)  # degenerate blocks: raw 8-bit literals
    tb[:2] = 8
    cases["degenerate"] = (blk, np.array([bs, 3000, bs], np.int32), tv, tb, hw, hb, n_words(tv, tb, blk, full, hb))
    blk, (tv, _), (hw, hb) = blocks(2), tables(2), header([70, 64])
    tb = np.full((2, 256), 32, np.int32)
    cases["32-bit"] = (blk, full[:2], tv, tb, hw, hb, n_words(tv, tb, blk, full, hb))
    blk, (tv, _), (hw, hb) = blocks(2), tables(2), header([70, 64])
    tb = np.tile(np.arange(256, dtype=np.int32) % 32 + 1, (2, 1))  # every width 1-32
    for r in range(2):  # the last byte of each tile tunes the tile's widths to 17 mod 32
        for t in range(bs // tile):
            last = t * tile + tile - 1
            rest = int(hb[r] if t == 0 else 0) + int(tb[r][blk[r, t * tile: last]].sum())
            blk[r, last] = (17 - rest - 1) % 32
    cases["boundary-words"] = (blk, full[:2], tv, tb, hw, hb, n_words(tv, tb, blk, full, hb))
    cut = int(hb[0] + tb[0][blk[0, :tile]].sum()) >> 5
    cases["drop-at-boundary"] = (blk, full[:2], tv, tb, hw, hb, cut)
    blk, (tv, tb), (hw, hb) = blocks(4), tables(1, 1, 10), header([75])
    nv = np.array([bs, tile, 17, 0], np.int32)
    cases["shared-table"] = (blk, nv, tv, tb, hw, hb, n_words(tv, tb, blk, nv, hb))
    return cases


def fibonacci(n: int) -> list:
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return fib[:n]


def table_rows() -> dict:
    """name -> a [256] int64 histogram: sigma 0, 1, 2, 3, 255 and 256; all
    counts equal; 1..256; Fibonacci counts over 31-34 symbols (codes of 30,
    31, 32 and 33 bits); zipf(1.3) rows; small counts with many ties; and
    rows past 2^31. The codes of "fibonacci 33-bit" are too long for one
    table. Kernel C's int32 instance takes the rows whose counts stay
    below 2^21, where its (count << 9) | symbol key stays below the absent
    symbols' key: INT32_ROWS."""
    rng = np.random.default_rng(12)
    rows = {}

    def row(name, sym, counts):
        h = np.zeros(256, np.int64)
        h[sym] = counts
        rows[name] = h

    row("sigma 0", [], [])
    row("sigma 1", [65], [7])
    row("sigma 2", [3, 200], [5, 9])
    row("sigma 3", [0, 9, 255], [4, 4, 4])
    row("sigma 255", np.arange(1, 256), rng.integers(1, 1000, 255))
    row("sigma 256", np.arange(256), rng.integers(1, 1 << 16, 256))
    row("all equal", np.arange(256), 5)
    row("1..256", np.arange(256), np.arange(1, 257))
    for n, bits in ((31, 30), (32, 31), (33, 32), (34, 33)):
        row(f"fibonacci {bits}-bit", rng.permutation(256)[:n], fibonacci(n))
    for size in (1 << 12, 1 << 18):
        row(f"zipf {size}", np.arange(256), np.bincount(rng.zipf(1.3, size).clip(0, 255), minlength=256))
    row("ties 1-3", np.arange(256), rng.integers(1, 4, 256))
    row("ties 1-2 sparse", rng.permutation(256)[:77], rng.integers(1, 3, 77))
    row("ties powers of 2", np.arange(256), 1 << rng.integers(0, 6, 256))
    row("past 2^31", np.arange(256), rng.integers(1, 1 << 16, 256) << 20)
    row("zipf past 2^31", np.arange(256), rows["zipf 262144"] << 16)
    return rows


INT32_ROWS = [n for n, h in table_rows().items() if h.max() < 1 << 21]


def _tiled_spans(rng, n_spans: int, widths, gap: int = 6) -> list:
    """n_spans disjoint spans in increasing order, span k of widths[k]
    blocks, 0 to `gap` blocks apart."""
    spans, at = [], 0
    for k in range(n_spans):
        at += int(rng.integers(0, gap + 1))
        spans.append((at, at + int(widths[k])))
        at += int(widths[k])
    return spans


def esp_edge_spans(device="cpu") -> dict:
    """Kernel I's edge cases, name -> (lens, typs, ws, we, ns) int32 tensors
    on `device` (tests/test_torch_esp.py, tests/test_torch_cuda.py,
    chip_smoke.py phase 12): spans of 1 to 260 blocks, all ones, alternating
    types, no spans at all and spans past ns; and for kernel I's warps,
    which stage 32 spans each in shared memory (csrc/esp.cu: SLOT, CAP):
    spans of width 1, ns at the static bound size // 7 + 1 with the last
    warp partly filled, a warp with one span wider than the slot, and a
    warp whose spans fill more than the warp's staging capacity."""
    rng = np.random.default_rng(12)
    cases = {}
    for width in (1, 2, 3, 7, 8, 129, 200, 260):
        lens = rng.choice([1, 2, 3], width).astype(np.int32)
        cases[f"width {width}"] = (lens, rng.integers(1, 4, width).astype(np.int32), [(0, width)])
    cases["all ones"] = (np.ones(300, np.int32), np.full(300, 2, np.int32), [(0, 300)])
    alt = np.tile(np.array([1, 2], np.int32), 150)
    cases["alternating types"] = (np.ones(300, np.int32), alt, [(0, 300)])
    cases["alternating types, lens"] = (np.tile(np.array([1, 3, 2], np.int32), 100),
                                       np.tile(np.array([3, 2, 1, 2], np.int32), 75), [(0, 150), (157, 300)])
    cases["no spans"] = (np.full(64, 2, np.int32), np.full(64, 2, np.int32), [])

    def blocks(size):
        return rng.choice([1, 2, 3], size, p=[0.4, 0.4, 0.2]).astype(np.int32), rng.integers(1, 4, size).astype(np.int32)

    lens, typs = blocks(700)
    cases["spans past ns"] = (lens, typs, _tiled_spans(rng, 40, rng.integers(1, 8, 40)), 0)
    lens, typs = blocks(1000)
    cases["spans of width 1"] = (lens, typs, _tiled_spans(rng, 120, np.ones(120, np.int64)))
    S = 35000 // 7 + 1  # 5001 spans: 156 full warps and one of 9
    lens, typs = blocks(35000)
    cases["ns at the static bound"] = (lens, typs, _tiled_spans(rng, S, rng.integers(1, 7, S), gap=3))
    lens, typs = blocks(1500)
    wid = rng.integers(1, 9, 40)
    wid[13] = 100  # wider than the slot: its lane walks device memory
    cases["one span wider than the slot"] = (lens, typs, _tiled_spans(rng, 40, wid))
    lens, typs = blocks(3000)
    cases["past a warp's staging capacity"] = (lens, typs, _tiled_spans(rng, 36, np.full(36, 64)))
    out = {}
    for name, (lens, typs, spans, *ns) in cases.items():
        S = len(lens) // 7 + 1
        assert len(spans) <= S and all(b <= len(lens) for _, b in spans)
        ws = np.zeros(S, np.int32)
        we = np.zeros(S, np.int32)
        for k, (a, b) in enumerate(spans):
            ws[k], we[k] = a, b
        n = np.array(ns or [len(spans)], np.int32)
        out[name] = tuple(torch.from_numpy(x).to(device) for x in (lens, typs, ws, we, n))
    return out


def mtf_edge_cases(chunk: int = 4096) -> dict:
    """Kernel J's edge inputs, name -> bytes (tests/test_torch_transforms.py,
    tests/test_torch_cuda.py, chip_smoke.py phase 16): empty, one byte, less
    than a chunk, a length that is no multiple of the chunk, one repeated
    byte, and a cycle of all 256 values (every rank 255 after the first
    lap); and for J3's walkers (a sub-chunk of chunk / 32 bytes each): less
    than a sub-chunk, one byte past a chunk, runs of one byte across every
    sub-chunk boundary, and permutations of all 256 values (each walker's
    sub-chunk holds all 256 at chunks of 8192)."""
    rng = np.random.default_rng(13)
    sub = chunk // 32
    runs = rng.integers(0, 26, 3 * chunk + 9).astype(np.uint8) + 97
    for b in range(sub, len(runs), sub):
        runs[b - 5 : b + 6] = 122
    return {
        "empty": b"",
        "one byte": b"\xff",
        "less than a chunk": english(chunk - 1),
        "ragged chunks": bytes(rng.integers(0, 26, 3 * chunk + 77).astype(np.uint8) + 97),
        "one repeated byte": b"z" * (2 * chunk + 5),
        "cycle of 256": bytes(range(256)) * (chunk // 64 + 3),
        "less than a sub-chunk": english(sub - 1),
        "one past a chunk": english(chunk + 1, seed=2),
        "runs across sub-chunks": runs.tobytes(),
        "permutations of 256": np.concatenate([rng.permutation(256) for _ in range(4 * chunk // 256 + 3)]).astype(np.uint8).tobytes(),
    }


# tests/test_matrix.py's seven texts (its default corpus)
MATRIX_TEXTS = [
    b"",
    b"a",
    b"abcdebcdeabc",
    b"aaaaaaaaa",
    b"foobar\0foobar",
    "ประเทศไทย中华".encode(),
    b"\xff\xfe\xc0 escape pool \xff\0",
]


def matrix_tail_inputs() -> dict:
    """The inputs of the lz78u, lfs_comp and lfs2 id tests: the seven
    matrix texts, 12 KiB of `english` and 12 KiB of seeded A/C/G/T."""
    acgt = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(5).integers(0, 4, 12 << 10)]
    return {
        **{f"matrix text {i}": t for i, t in enumerate(MATRIX_TEXTS)},
        "english 12 KiB": english(12 << 10, seed=3),
        "acgt 12 KiB": acgt.tobytes(),
    }
