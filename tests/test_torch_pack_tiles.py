"""The tile schedule of kernels A and B (csrc/pack.cu), done CTA by CTA on the CPU.

`emulate` does what each CTA of pack_tiles_kernel does, in reverse tile
order (no tile reads another's output): its start bit from the tile totals
of the first pass, its window of words, the words it owns (a word belongs
to the tile holding its last bit, or the row's last bit; tile 0 holds the
header), the walk-back of warp 0 over the earlier tokens for a cut word, 32
tokens a step, skipping tiles without bits, the header words ORed into the
words below min(H, n_words), and its share of the zeroed tail. It counts
the stores into an arena of random words and asserts one store a word.
It is held exactly to ops/bitpack.pack_rows and kernel B's plain version,
to the JAX package's vmapped pack_tokens, and, for kernel B's edge cases,
to pack_bytes_blocks_pallas in interpret mode: at csrc/pack.cu's tiles
(kernel A 1024 tokens, kernel B 8192 bytes; A also at 8192) and at a tile
of 64, where the same inputs cross many more boundaries. The card runs the
same cases (tests/torch_cases.py) in tests/test_torch_cuda.py, and
test_tile_sizes_match_pack_cu holds bitpack_cuda's tile sizes to
csrc/pack.cu's constants.
Tolerance: exact equality (integer arithmetic).
"""

import os
import re
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tudocomp_tpu.ops.bitpack import pack_tokens as jax_pack_tokens
from tudocomp_tpu.ops.bitpack_pallas import pack_bytes_blocks_pallas
from tudocomp_tpu_torch.ops import bitpack_cuda as bc
from tudocomp_tpu_torch.ops.bitpack import pack_rows

from tests.test_torch_bitpack import CASES as PALLAS_CASES
from tests.torch_cases import pack_bytes_edge_cases, pack_edge_cases

A_TILES = [bc.TILE_B, bc.TILE_A, 64]  # A's schedule is the same at B's tile
B_TILES = [bc.TILE_B, 64]
U32 = 0xFFFFFFFF


def _parts(v, nb, off):
    """(hi, lo) int64 arrays: the parts of tokens (v, nb) at bit offsets off
    for word off >> 5 and the word after (0 for width 0)."""
    v, nb, off = (np.asarray(x, np.int64) for x in (v, nb, off))
    vm = np.where(nb >= 32, v & U32, v & ((1 << np.clip(nb, 0, 31)) - 1))
    sh_end = (off & 31) + nb
    hi = np.where(sh_end <= 32, vm << np.clip(32 - sh_end, 0, 31), vm >> np.clip(sh_end - 32, 0, 31))
    lo = np.where(sh_end > 32, (vm << np.clip(64 - sh_end, 0, 31)) & U32, 0)
    return np.where(nb > 0, hi & U32, 0), np.where(nb > 0, lo, 0)


def emulate(vals, nbits, n_words, tile, start=None, hdr=None):
    """(words uint32 [B, n_words], bits [B], walk-back steps of each tile
    that took one) by csrc/pack.cu's schedule at `tile` tokens a CTA.
    vals, nbits [B, NT]: the tokens (widths 0 for B's dead bytes); start [B]
    and hdr [B, H] (kernel B): the header's bits and words."""
    B, NT = nbits.shape
    T = 1 if NT <= tile else -(-NT // tile)
    k_hdr = 0 if hdr is None else min(hdr.shape[1], n_words)
    words = np.random.default_rng(2).integers(0, 1 << 32, (B, n_words), dtype=np.uint64)
    stores = np.zeros((B, n_words), np.int64)
    bits = np.zeros(B, np.int64)
    steps = []

    for b in range(B):
        nb = nbits[b].astype(np.int64)
        v = vals[b].astype(np.int64) & U32
        sums = [int(nb[t * tile:(t + 1) * tile].sum()) for t in range(T)]  # the first pass
        S = 0 if start is None else int(start[b])
        total = S + sum(sums)

        def store(w, x):
            words[b, w] = x
            stores[b, w] += 1

        for t in reversed(range(T)):
            s = S + sum(sums[:t])
            e = s + sums[t]
            a0 = 0 if t == 0 else s
            owns_end = e == total and (e > a0 or t == 0)
            lo = a0 >> 5
            hi = (((total + 31) >> 5) - 1 if owns_end else (e >> 5) - 1) if e > a0 else lo - 1
            base = s >> 5
            win = np.zeros(max(((e + 31) >> 5) - base, 0), np.int64)
            sl = slice(t * tile, (t + 1) * tile)
            tnb, tv = nb[sl], v[sl]
            off = s + np.cumsum(tnb) - tnb
            p_hi, p_lo = _parts(tv, tnb, off)
            live = tnb > 0
            np.bitwise_or.at(win, (off >> 5)[live] - base, p_hi[live])
            spill = live & ((off & 31) + tnb > 32)
            np.bitwise_or.at(win, (off >> 5)[spill] + 1 - base, p_lo[spill])
            if t > 0 and s & 31 and lo <= hi:  # warp 0 walks back
                need, covered, k, earlier, n = s & 31, 0, t * tile, 0, 0
                while covered < need and k > 0:
                    if k % tile == 0 and sums[k // tile - 1] == 0:
                        k -= tile
                        continue
                    cnb, cv = nb[k - 32:k], v[k - 32:k]
                    suffix = np.cumsum(cnb[::-1])[::-1]
                    tok_end = s - covered - (suffix - cnb)
                    c_hi, c_lo = _parts(cv, cnb, tok_end - cnb)
                    tw = (tok_end - cnb) >> 5
                    reach = (cnb > 0) & (tok_end > 32 * lo)
                    earlier |= int(np.bitwise_or.reduce(np.where(reach & (tw == lo), c_hi, 0)))
                    earlier |= int(np.bitwise_or.reduce(np.where(reach & (tw + 1 == lo), c_lo, 0)))
                    covered += int(suffix[0])
                    k -= 32
                    n += 1
                win[0] |= earlier
                steps.append(n)
            for w in range(lo, min(hi, n_words - 1) + 1):
                x = int(win[w - base]) if w >= base else 0
                store(w, x | (int(hdr[b, w]) if w < k_hdr else 0))
            tail = (total + 31) >> 5
            if tail < n_words:
                n = n_words - tail
                for w in range(tail + n * t // T, tail + n * (t + 1) // T):
                    store(w, int(hdr[b, w]) if w < k_hdr else 0)
            if t == 0:
                bits[b] = total
    assert (stores == 1).all(), "a word stored more or less than once"
    return words.astype(np.uint32), bits, steps


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@partial(jax.jit, static_argnums=2)
def _jax_pack_jit(values, nbits, n_words):
    return jax.vmap(lambda v, n: jax_pack_tokens(v, n, n_words))(values, nbits)


A_CASES = {**{f"pallas-{k}": v for k, v in PALLAS_CASES.items()},
           **{f"edge-{k}": v for k, v in pack_edge_cases().items()}}


@pytest.mark.parametrize("tile", A_TILES)
@pytest.mark.parametrize("name", sorted(A_CASES))
def test_kernel_a_tile_schedule(name, tile):
    values, nbits, n_words = A_CASES[name]
    if name.startswith("edge-") and tile != bc.TILE_A:
        values, nbits, n_words = pack_edge_cases(tile)[name[5:]]
    words, bits, _ = emulate(values, nbits, n_words, tile)
    want_w, want_b = pack_rows(_t(values), _t(nbits), n_words)
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))
    np.testing.assert_array_equal(bits, want_b.numpy())
    if nbits.shape[1]:
        jw, jb = _jax_pack_jit(jnp.asarray(values), jnp.asarray(nbits), n_words)
        np.testing.assert_array_equal(words, np.asarray(jw))
        np.testing.assert_array_equal(bits, np.asarray(jb))


def _b_inputs(case):
    """Kernel B's arguments as CPU tensors, a shared table and header expanded to the batch."""
    blocks, n_valid, tv, tb, hw, hb, n_words = case
    B = blocks.shape[0]
    tv, tb, hw, hb = (_t(x) for x in (tv, tb, hw, hb))
    if tv.shape[0] != B:
        tv, tb, hw, hb = (x.expand(B, *x.shape[1:]) for x in (tv, tb, hw, hb))
    return (torch.from_numpy(blocks), torch.from_numpy(n_valid), tv, tb, hw, hb), n_words


def _b_emulate(case, tile):
    blocks, n_valid, tv, tb, hw, hb, n_words = case
    B, bs = blocks.shape
    r = np.arange(B) % tv.shape[0]
    vals = np.take_along_axis(tv[r].astype(np.int64), blocks.astype(np.int64), 1)
    nb = np.take_along_axis(tb[r].astype(np.int64), blocks.astype(np.int64), 1)
    nb = np.where(np.arange(bs)[None, :] < n_valid[:, None], nb, 0)
    return emulate(vals, nb, n_words, tile, start=hb[r], hdr=hw[r].astype(np.int64))


@pytest.mark.parametrize("tile", B_TILES)
@pytest.mark.parametrize("name", sorted(pack_bytes_edge_cases()))
def test_kernel_b_tile_schedule(name, tile):
    """The emulated schedule against kernel B's plain version; at the
    kernel's tile a walk-back over live bytes (widths >= 1) takes one step."""
    case = pack_bytes_edge_cases(tile)[name]
    words, bits, steps = _b_emulate(case, tile)
    args, n_words = _b_inputs(case)
    want_w, want_b = bc.pack_bytes_blocks(*args, n_words)  # CPU tensors: the plain version
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))
    np.testing.assert_array_equal(bits, want_b.numpy())
    if tile == bc.TILE_B:
        assert steps and max(steps) == 1, steps


@pytest.mark.parametrize("name", sorted(pack_bytes_edge_cases()))
def test_kernel_b_edge_cases_match_pallas(name):
    """Kernel B's edge cases, made for a tile of 2048 bytes to keep the
    interpreter short, against the Pallas kernel in interpret mode."""
    case = pack_bytes_edge_cases(2048)[name]
    args, n_words = _b_inputs(case)
    words, bits = bc.pack_bytes_blocks(*args, n_words)
    blocks, n_valid, tv, tb, hw, hb = (x.numpy() for x in args)
    want_w, want_b = pack_bytes_blocks_pallas(*(jnp.asarray(x) for x in (blocks, n_valid, tv, tb, hw.view(np.uint32), hb)),
                                              n_words, interpret=True)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(want_w))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))


def test_edge_cases_cut_words_at_tile_boundaries():
    """The cases hold what their names say at the kernel's tile: every
    boundary of row 0 cuts a word, and the drop begins in tile 1's first word."""
    values, nbits, n_words = pack_edge_cases()["boundary-words"]
    starts = np.cumsum(nbits[0].astype(np.int64))[bc.TILE_A - 1::bc.TILE_A]
    assert len(starts) == 3 and (starts % 32 != 0).all()
    assert (np.cumsum(nbits[1].astype(np.int64))[bc.TILE_A - 1::bc.TILE_A] % 32 == 0).all()
    blocks, n_valid, tv, tb, hw, hb, n_words = pack_bytes_edge_cases()["drop-at-boundary"]
    s1 = int(hb[0] + tb[0][blocks[0, :bc.TILE_B]].sum())
    assert s1 % 32 and n_words == s1 >> 5


def test_launch_args_pass_a_shared_row_with_stride_0():
    """Kernel B's launcher takes an expanded table and header as one row
    with a row stride of 0 (no copy a block), per-block ones with their own
    stride, and a scratch for the first pass: each tile's and each thread's
    widths."""
    blocks, n_valid, tv, tb, hw, hb, n_words = pack_bytes_edge_cases()["shared-table"]
    (blk, nv, tv, tb, hw, hb), n_words = _b_inputs((blocks, n_valid, tv, tb, hw, hb, n_words))
    args = bc.launch_args_b(blk, nv, tv, tb, hw, hb, n_words)
    assert args[2].data_ptr() == tv.data_ptr() and args[4] == 0  # the table: one row, stride 0
    assert args[5].data_ptr() == hw.data_ptr() and args[6] == 0 and args[7] == hw.shape[1]
    assert args[9] == 0 and args[10:13] == (4, blocks.shape[1], n_words)
    assert tuple(args[13].shape) == (4 * -(-blocks.shape[1] // bc.TILE_B) * (bc.THREADS + 1),)
    assert tuple(args[-2].shape) == (4, n_words) and tuple(args[-1].shape) == (4,)
    one = bc.launch_args_b(blk[:, :100].contiguous(), nv, tv.contiguous(), tb.contiguous(), hw, hb, 40)
    assert one[4] == 256 and one[13].numel() == 4 * (bc.THREADS + 1)  # per-block tables; one tile a row


def test_launch_args_a_one_tile_takes_no_scratch():
    values, nbits, n_words = pack_edge_cases()["header-rows"]
    args = bc.launch_args_a(_t(values), _t(nbits), n_words)
    assert args[2:6] == (4, 393, n_words, None)
    values, nbits, n_words = pack_edge_cases()["zero-runs"]
    assert tuple(bc.launch_args_a(_t(values), _t(nbits), n_words)[5].shape) == (3, 4)


def test_tile_sizes_match_pack_cu():
    """bitpack_cuda sizes the first pass's scratch from TILE_A and TILE_B:
    they must be csrc/pack.cu's THREADS times ITEMS_A and ITEMS_B, or the
    first pass would write past the scratch."""
    src = os.path.join(os.path.dirname(bc.__file__), os.pardir, "csrc", "pack.cu")
    with open(src) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (THREADS|ITEMS_A|ITEMS_B) = (\d+);", text)}
    assert const == {"THREADS": bc.THREADS, "ITEMS_A": bc.TILE_A // bc.THREADS, "ITEMS_B": bc.TILE_B // bc.THREADS}
    assert bc.TILE_A % bc.THREADS == 0 and bc.TILE_B % bc.THREADS == 0
    assert pack_edge_cases()["header-rows"][1].shape[1] <= bc.TILE_A  # a header row is one tile
