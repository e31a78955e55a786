"""The shared-table Huffman path of the port, blockwise(encode(huff),shared=1), on the CPU.

Kernel G's plain version (moffat_phase12_plain) is held to the JAX
package's Pallas kernel in interpret mode and to its XLA loop; the port's
code_lengths_batch to huffman_jax.code_lengths_batch; the port's shared
containers to the JAX package's, byte for byte, wherever every summed
count is below 2^22. Past that the JAX package's int32 sort key wraps, so
the port is held instead to what a Huffman code is: Kraft's equality, every
present symbol coded, and the cost of the JAX package's heap Huffman
(coders/huffman.py:gen_codelengths). Tolerance: exact equality throughout,
since every stage is integer arithmetic.

Run as a script, it measures that trap on the CPU instead (one JSON line
per result): for the summed histograms of zipf(1.3) inputs of 1, 16 and
240 MiB, the largest count, the Kraft sum of huffman_jax's lengths, the
present symbols it leaves at length 0, and whether its Pallas kernel
(interpret mode) equals its XLA loop there; then 16 MiB through
blockwise(encode(huff)) with and without shared=1 in the JAX package, and
with shared=1 through the port.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_shared.py
"""

import functools
import json
import os
from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tudocomp_tpu.coders.huffman import gen_codelengths
from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.ops import huffman_jax as H
from tudocomp_tpu.ops.pallas_kernels import moffat_phase12 as pallas_moffat_phase12
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ops import huffman_torch as T
from tudocomp_tpu_torch.ops.table_kernels import moffat_phase12, moffat_phase12_plain

ALGO = "blockwise(encode(huff),bs=65536,shared=1)"


def _fib(n):
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return fib


def _hists_69():
    """64 zipf(1.3) histograms of 256 KiB blocks and the edge rows: sigma 0,
    1, 2 and 256, and Fibonacci weights (codes of 30 bits)."""
    rng = np.random.default_rng(7)
    zipf = rng.zipf(1.3, (64, 1 << 18)).clip(0, 255)
    hists = np.stack([np.bincount(row, minlength=256) for row in zipf])
    edge = np.zeros((5, 256), np.int64)
    edge[1, 65] = 7
    edge[2, [3, 200]] = [5, 9]
    edge[3] = np.arange(1, 257)
    edge[4, :31] = _fib(31)
    return np.concatenate([hists, edge]).astype(np.int32)


HISTS = _hists_69()


@functools.lru_cache(maxsize=1)
def _jax_sorted():
    """The JAX package's sorted weights and sigmas of HISTS (its _sort_hist)."""
    keys, _, sigmas, _ = jax.vmap(H._sort_hist)(jnp.asarray(HISTS))
    return np.asarray(keys), np.asarray(sigmas)


@pytest.mark.parametrize("rows", [slice(0, 1), slice(0, 69)], ids=["B=1", "B=69"])
def test_moffat_plain_matches_pallas_and_xla(rows):
    keys, sigmas = (x[rows] for x in _jax_sorted())
    got = moffat_phase12(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(sigmas.copy()))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas_moffat_phase12(keys, sigmas, interpret=True)))
    # the XLA loop also rewrites slot 0 of rows with sigma <= 1: compare the
    # internal-node depths, slots 0..sigma-2, the only slots phase 3 reads
    xla = np.asarray(jax.vmap(H._phase12_xla)(jnp.asarray(keys), jnp.asarray(sigmas)))
    internal = np.arange(256)[None, :] < (sigmas.astype(np.int64) - 1)[:, None]
    np.testing.assert_array_equal(np.where(internal, got.numpy(), 0), np.where(internal, xla, 0))
    if rows.stop == 69:
        assert sorted(set(sigmas[-5:].tolist())) == [0, 1, 2, 31, 256]


def test_code_lengths_match_jax():
    got = T.code_lengths_batch(torch.from_numpy(HISTS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(H.code_lengths_batch(jnp.asarray(HISTS))))


def test_moffat_wrapper_checks_its_inputs():
    w = torch.zeros((2, 256), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        moffat_phase12(w.to(torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="sigma"):
        moffat_phase12_plain(w, torch.zeros(3, dtype=torch.int32))
    w = torch.arange(512, dtype=torch.int64).reshape(2, 256)
    clamped = moffat_phase12_plain(w, torch.tensor([-5, 300], dtype=torch.int32))
    assert torch.equal(clamped, moffat_phase12_plain(w, torch.tensor([0, 256], dtype=torch.int32)))


def _containers():
    rng = np.random.default_rng(17)
    zipf = bytes(rng.zipf(1.3, 1 << 20).clip(0, 255).astype(np.uint8))
    text = (b"A shared table codes every block with one Huffman code. " * 20000)[: (1 << 20) - 3]
    return {
        "zipf 1 MiB": zipf,
        "ragged last block": zipf[: (1 << 20) - 4321],
        "text": text,
        "one repeated byte": b"\x07" * (1 << 20),
        "empty": b"",
    }


CONTAINERS = _containers()


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_shared_container_matches_jax(name, monkeypatch):
    data = CONTAINERS[name]
    monkeypatch.delenv("TDC_DEVICE_HUFF", raising=False)
    want = jax_compress(ALGO, data)
    got = compress(ALGO, data, device="cpu")
    assert got == want
    assert decompress(got, device="cpu") == data
    monkeypatch.setenv("TDC_DEVICE_HUFF", "0")  # the JAX package's host decoder, not Pallas in interpret mode
    assert jax_decompress(got) == data


def test_batches_share_the_whole_input_table(monkeypatch):
    """Encoded in eight batches of two blocks, every block still carries the
    one table of the whole input: the JAX package's container, which
    encodes all blocks in one step."""
    from tudocomp_tpu_torch.parallel import runtime

    data = CONTAINERS["ragged last block"]
    monkeypatch.delenv("TDC_DEVICE_HUFF", raising=False)
    want = jax_compress(ALGO, data)
    monkeypatch.setattr(runtime, "_BATCH_BYTES", 2 * 65536)
    assert compress(ALGO, data, device="cpu") == want


def _kraft_and_cost(hist, lengths):
    present = hist > 0
    assert (lengths[present] > 0).all() and (lengths[~present] == 0).all()
    kraft = sum(Fraction(1, 2 ** int(l)) for l in lengths[present])
    return kraft, int((hist.astype(object) * lengths.astype(object)).sum())


@functools.lru_cache(maxsize=1)
def _zipf_16mib_hist():
    rng = np.random.default_rng(3)
    return np.bincount(rng.zipf(1.3, 1 << 24).clip(0, 255), minlength=256).astype(np.int64)


@pytest.mark.parametrize("scale", [1, 15, 1000], ids=["16 MiB", "240 MiB", "weights past 2^31"])
def test_large_counts_give_an_optimal_prefix_code(scale):
    hist = _zipf_16mib_hist() * scale
    assert hist.max() >= 1 << 22
    lengths = T.code_lengths_batch(torch.from_numpy(hist[None]))[0].numpy().astype(np.int64)
    kraft, cost = _kraft_and_cost(hist, lengths)
    assert kraft == 1
    eff = np.flatnonzero(hist)
    heap = gen_codelengths(hist[eff]).astype(np.int64)
    assert cost == int((hist[eff].astype(object) * heap.astype(object)).sum())


def test_large_counts_roundtrip_through_both_decoders(monkeypatch):
    """4.3 MB of one byte and 200 KB of random bytes, bs 1 MiB: the shared
    histogram's top count passes 2^22."""
    rng = np.random.default_rng(5)
    data = b"e" * 4_300_000 + bytes(rng.integers(0, 256, 200_000).astype(np.uint8))
    algo = "blockwise(encode(huff),bs=1048576,shared=1)"
    monkeypatch.delenv("TDC_DEVICE_HUFF", raising=False)
    got = compress(algo, data, device="cpu")
    assert decompress(got, device="cpu") == data
    monkeypatch.setenv("TDC_DEVICE_HUFF", "0")
    assert jax_decompress(got) == data


def test_codes_past_32_bits_raise():
    hist = np.zeros((1, 256), np.int64)
    hist[0, :33] = _fib(33)  # a caterpillar tree: codes of 32 bits
    assert int(T.code_lengths_batch(torch.from_numpy(hist)).max()) == 32
    hist[0, :34] = _fib(34)  # 33 bits
    with pytest.raises(ValueError, match="33-bit codes"):
        T.shared_tables(torch.from_numpy(hist[0]))


MIB = 1 << 20


def zipf_hist(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hist = np.zeros(256, np.int64)
    for lo in range(0, n, 16 * MIB):
        hist += np.bincount(rng.zipf(1.3, min(16 * MIB, n - lo)).clip(0, 255), minlength=256)
    return hist


def trap_report() -> None:
    for mib in (1, 16, 240):
        hist = zipf_hist(0, mib * MIB)
        h32 = jnp.asarray(hist.astype(np.int32))[None]
        lengths = np.asarray(H.code_lengths_batch(h32))[0].astype(np.int64)
        present = hist > 0
        # over the present symbols; one left with length 0 counts 2^0
        kraft = sum(Fraction(1, 2 ** int(l)) for l in lengths[present])
        keys, _, sigmas, _ = jax.vmap(H._sort_hist)(h32)
        pallas = np.asarray(pallas_moffat_phase12(keys, sigmas, interpret=True))
        xla = np.asarray(jax.vmap(H._phase12_xla)(keys, sigmas))
        m = int(sigmas[0])
        print(json.dumps({
            "input_MiB": mib, "max_count": int(hist.max()), "kraft_sum": float(kraft),
            "present_symbols_with_length_0": int((present & (lengths == 0)).sum()),
            "pallas_equals_xla": bool((pallas[0, : m - 1] == xla[0, : m - 1]).all()),
        }), flush=True)

    rng = np.random.default_rng(1)
    data = rng.zipf(1.3, 16 * MIB).clip(0, 255).astype(np.uint8).tobytes()
    os.environ["TDC_DEVICE_HUFF"] = "0"  # decode with the JAX package's host decoder
    for algo in ("blockwise(encode(huff),shared=1)", "blockwise(encode(huff))"):
        os.environ.pop("TDC_DEVICE_HUFF")
        c = jax_compress(algo, data)
        os.environ["TDC_DEVICE_HUFF"] = "0"
        back = jax_decompress(c)
        n = min(len(back), len(data))
        diff = np.flatnonzero(np.frombuffer(back[:n], np.uint8) != np.frombuffer(data[:n], np.uint8))
        print(json.dumps({
            "package": "tudocomp_tpu", "algo": algo, "bytes": len(data), "ratio": len(c) / len(data),
            "decoded_bytes": len(back), "roundtrips": back == data,
            "first_difference": int(diff[0]) if len(diff) else None,
        }), flush=True)
    c = compress("blockwise(encode(huff),shared=1)", data, device="cpu")
    print(json.dumps({
        "package": "tudocomp_tpu_torch", "algo": "blockwise(encode(huff),shared=1)", "bytes": len(data),
        "ratio": len(c) / len(data), "roundtrips_port_host": decompress(c, device="cpu") == data,
        "roundtrips_jax_host": jax_decompress(c) == data,
    }), flush=True)


if __name__ == "__main__":
    trap_report()
