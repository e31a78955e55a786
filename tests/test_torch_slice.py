"""The ported slice, blockwise(encode(huff)), on the CPU, against the JAX package.

The port's runtime and driver (device stages on the CPU through the
kernels' plain versions, TDC_DEVICE_HUFF=1) must write the container the
JAX package writes, byte for byte, and each package must decode the
other's; so must the port's host path for every other id it registers
(each coder, trie and hash axis). Tolerance: exact equality, since every
stage is integer arithmetic. The jax-free cases run the port in a
subprocess with jax and the JAX package blocked from import, and a static
check reads every import of the port.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.parallel import runtime as jax_runtime
from tudocomp_tpu_torch import __main__ as cli
from tudocomp_tpu_torch.device import resolve
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ops import huffman_torch as ht
from tudocomp_tpu_torch.ops.bitpack import finalize_stream
from tudocomp_tpu_torch.parallel import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4096  # at most 8 blocks per case: one compiled shape on the 8-device CPU mesh
ALGO = f"blockwise(encode(huff),bs={BS})"


def _fib_skew():
    fib = [1, 1]
    while sum(fib) < 10000:
        fib.append(fib[-1] + fib[-2])
    return b"".join(bytes([i]) * n for i, n in enumerate(fib))


def _cases():
    rng = np.random.default_rng(11)
    return {
        "empty": b"",
        "one-byte": b"x",
        "block-plus-one": bytes(rng.integers(0, 256, BS + 1).astype(np.uint8)),
        "all-bytes": bytes(range(256)) * 20,
        "deep-skew": _fib_skew(),
        "zipf": bytes(rng.zipf(1.3, 7 * BS - 123).clip(0, 255).astype(np.uint8)),
    }


CASES = _cases()


def test_runtime_matches_jax_runtime():
    data = CASES["zipf"]
    got = runtime.blockwise_huffman_compress(data, BS, "cpu")
    assert got == jax_runtime.blockwise_huffman_compress(data, BS)
    assert runtime.blockwise_huffman_decompress(got, "cpu") == data


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_matches_jax_driver(name, monkeypatch):
    data = CASES[name]
    want = jax_compress(ALGO, data)
    assert jax_decompress(want) == data
    monkeypatch.setenv("TDC_DEVICE_HUFF", "1")  # read by both packages: set for the port only
    got = compress(ALGO, data, device="cpu")
    assert got == want
    assert decompress(want, device="cpu") == data
    monkeypatch.delenv("TDC_DEVICE_HUFF")
    assert jax_decompress(got) == data


def test_encode_blocks_match_host_coder():
    """Per-block streams of encode_blocks (tables from kernel C's plain
    version) and of encode_blocks_from_lengths equal the host coder's."""
    payloads = [CASES[k] for k in ("empty", "one-byte", "all-bytes", "zipf")] + [b"x" * 500, b"ab"]
    bs = max(len(p) for p in payloads)
    blocks = np.zeros((len(payloads), bs), np.uint8)
    for i, p in enumerate(payloads):
        blocks[i, : len(p)] = np.frombuffer(p, np.uint8)
    b = torch.from_numpy(blocks)
    nv = torch.tensor([len(p) for p in payloads], dtype=torch.int32)
    n_words = (9 * bs + 4096 + 31) // 32
    want = [jax_compress("encode(huff)", p, raw=True) for p in payloads]
    lengths = ht.huffman_tables(ht.block_histograms(b, nv)).lengths
    for words, bits in (ht.encode_blocks(b, nv, n_words), ht.encode_blocks_from_lengths(b, nv, lengths, n_words)):
        got = [finalize_stream(words[i].numpy(), int(bits[i])) for i in range(len(payloads))]
        assert got == want


def test_host_coder_path_matches(monkeypatch):
    data = CASES["zipf"]
    want = jax_compress(ALGO, data)
    monkeypatch.setenv("TDC_DEVICE_HUFF", "0")
    got = compress(ALGO, data, device="cpu")
    assert got == want
    assert decompress(got, device="cpu") == data


def test_more_than_one_device_raises():
    """A device list in one process raises and names the way: one process
    for each card (a process group; tests/test_torch_distributed.py)."""
    with pytest.raises(ValueError, match="one process for each card"):
        resolve(["cuda:0", "cuda:1"])


def test_cli_roundtrip(tmp_path, monkeypatch):
    want = jax_compress(ALGO, CASES["zipf"])
    monkeypatch.setenv("TDC_DEVICE_HUFF", "1")
    src = tmp_path / "in.bin"
    src.write_bytes(CASES["zipf"])
    assert cli.main(["-a", ALGO, "--device", "cpu", str(src)]) == 0
    packed = tmp_path / "in.bin.tdc"
    assert packed.read_bytes() == want
    out = tmp_path / "out.bin"
    assert cli.main(["-d", str(packed), "-o", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == CASES["zipf"]


_JAX_FREE = textwrap.dedent(
    """
    import os, sys
    sys.modules["jax"] = None  # any import of jax now fails
    NO_LZ78 = (("lz78", "arithmetic"), ("lz78", "sle"))  # lz78 feeds these coders no literals
    sys.modules["tudocomp_tpu"] = None  # and of the JAX package
    os.environ["TDC_DEVICE_HUFF"] = "1"
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.registry import TorchRegistry
    data = bytes(range(256)) * 40 + b"jax-free roundtrip" * 100
    if sys.argv[1] == "cpu":
        c = compress("blockwise(encode(huff),bs=4096)", data, device="cpu")
        assert decompress(c, device="cpu") == data
        for parse in ("1", "0"):  # the lz78 parse's plain version, then the host parse
            os.environ["TDC_DEVICE_LZ78"] = parse
            c = compress("blockwise(lz78(coder=bit),bs=1024)", data, device="cpu")
            assert decompress(c, device="cpu") == data
        # every id the port registers: each coder under encode, lz78 and
        # lzw, each lz78trie, and blockwise with a shared table
        reg = TorchRegistry("cpu")
        coders = reg.names("coder")
        ids = [f"{c}({k})" for c in ("encode", "lz78", "lzw") for k in coders if (c, k) not in NO_LZ78]
        coders = [k for k in coders if k != "arithmetic"]
        ids += [f"lz78(coder=bit,lz78trie={t})" for t in reg.names("lz78trie")]
        ids += ["blockwise(encode(huff),bs=4096,shared=1)", "blockwise(lzw(coder=gamma),bs=4096)"]
        # the lzss_lcp slice: every coder, the textds providers, blockwise
        ids += [f"lzss_lcp(coder={k})" for k in coders]
        ids += ["lzss_lcp(coder=huff,textds=textds(isa=sparse_isa,lcp=compressed_lcp,cm=delayed))",
                "blockwise(lzss_lcp(coder=huff),bs=4096)", "blockwise(lzss_lcp(coder=huff),bs=4096,shared=1)"]
        for algo in ids:
            c = compress(algo, data, device="cpu")
            assert decompress(c, device="cpu") == data, algo
        lzss = ("lzss_lcp(coder=huff)", "blockwise(lzss_lcp(coder=huff),bs=4096,shared=1)")
        host = [compress(algo, data, device="cpu") for algo in lzss]
        for sa, lz in ("11", "10", "01"):  # the device suffix array and factorization, forced
            os.environ["TDC_DEVICE_SA"], os.environ["TDC_DEVICE_LZSS"] = sa, lz
            assert [compress(algo, data, device="cpu") for algo in lzss] == host, (sa, lz)
        lcpcomp = ("lcpcomp(coder=huff)", "lcpcomp(coder=sle,comp=plcppeaks,dec=compact)")
        host = [compress(algo, data, device="cpu") for algo in lcpcomp]
        os.environ["TDC_DEVICE_LCPCOMP"] = "1"  # the plcppeaks walk and the chain-resolving decode, forced
        assert [compress(algo, data, device="cpu") for algo in lcpcomp] == host
        assert all(decompress(c, device="cpu") == data for c in host)
        esp_ids = ["esp", "esp(slp_coder=sorted)", "esp(slp_coder=sorted(d_coding=arith))"]
        esp_data = data * 6  # past 2 x esp_grammar_device's threshold: one device round
        host = [compress(algo, esp_data, device="cpu") for algo in esp_ids]
        os.environ["TDC_DEVICE_ESP"] = "1"  # the device rounds, forced (kernel I's plain version)
        assert [compress(algo, esp_data, device="cpu") for algo in esp_ids] == host
        assert all(decompress(c, device="cpu") == esp_data for c in host)
        # the transforms, bwt, lzss and repair: the device stages' plain
        # versions (the run split, kernel J's, the device SA), then the host
        for gate in ("1", "0"):
            for var in ("TDC_DEVICE_RLE", "TDC_DEVICE_MTF", "TDC_DEVICE_SA"):
                os.environ[var] = gate
            for algo in ("rle:mtf:encode(vbyte)", "bwt:rle:mtf:encode(huff)", "noop", "lzss(coder=bit)",
                         "repair(coder=huff)"):
                c = compress(algo, data, device="cpu")
                assert decompress(c, device="cpu") == data, (algo, gate)
        # the suffix-tree families, the device suffix stack's plain
        # versions then the host's, and a nested blockwise
        for gate in ("1", "0"):
            os.environ["TDC_DEVICE_SA"] = gate
            for algo in ("lz78u", "lfs_comp(computing_strat=st)", "lfs2", "lfs2bst",
                         "blockwise(blockwise(encode(huff),bs=1024),bs=4096)"):
                c = compress(algo, data, device="cpu")
                assert decompress(c, device="cpu") == data, (algo, gate)
        import tempfile
        from tudocomp_tpu_torch import __main__ as cli
        out = os.path.join(tempfile.mkdtemp(), "fib.tdc")
        assert cli.main(["-g", "fib(n=10)", "-a", "lz78u", "-o", out, "--device", "cpu"]) == 0
        assert cli.main(["-d", out, "-o", out + ".out", "--device", "cpu"]) == 0
        from tudocomp_tpu_torch.generators.generators import fibonacci_word
        assert open(out + ".out", "rb").read() == fibonacci_word(10)
        from tudocomp_tpu_torch import probes
        assert probes.main(["6", "7", "8", "--device", "cpu"]) == 0
        print(len(ids), "ids")
    else:
        try:
            compress("blockwise(encode(huff))", data, device="cuda")
        except RuntimeError as e:
            print("raised:", e)
        else:
            sys.exit("device='cuda' did not raise")
    loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "tudocomp_tpu")]
    assert not loaded, loaded
    print("ok")
    """
)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_port_runs_without_jax(device):
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this case checks the machine without one")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_FREE, device],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def _host_ids():
    """Every id the port registers outside blockwise: each coder under
    encode, lz78, lzw and lzss_lcp, each lz78trie under lz78 and lzw, the
    hash axes of the hash tries, and the textds providers."""
    from tudocomp_tpu_torch.registry import TorchRegistry

    reg = TorchRegistry("cpu")
    # the consuming coders encode under lz78 in neither package, and the
    # arithmetic coder does not roundtrip under lzss_lcp
    # (test_arithmetic_under_lz78_and_lzss_fails_in_both_packages,
    # test_sle_under_lz78_fails_in_both_packages)
    no_lz78 = (("lz78", "arithmetic"), ("lz78", "sle"))
    ids = [f"{c}({k})" for c in ("encode", "lz78", "lzw") for k in reg.names("coder") if (c, k) not in no_lz78]
    ids += [f"lzss_lcp(coder={k})" for k in reg.names("coder") if k != "arithmetic"]
    ids += [f"lzss_lcp(coder=huff,textds=textds(isa={i},lcp={l}))" for i in reg.names("isa") for l in reg.names("lcp")]
    ids += [f"{c}(coder=bit,lz78trie={t})" for c in ("lz78", "lzw") for t in reg.names("lz78trie")]
    ids += [
        "lz78(coder=gamma,lz78trie=hash(hash_function=vigna,hash_prober=quadratic,hash_manager=direct))",
        "lz78(coder=bit,lz78trie=hash(hash_function=noop,hash_prober=double,hash_manager=prime))",
        "lz78(coder=delta,lz78trie=hash_plus(hash_function=knuth,hash_manager=prime))",
        "lzw(coder=bit,lz78trie=hash(hash_function=knuth,hash_prober=gauss))",
        "lz78(coder=bit,lz78trie=rolling(hash_roll=karprabin,hash_prober=gauss))",
    ]
    return ids


_HOST_DATA = CASES["deep-skew"][:4000] + b"abracadabra, abracadabra " * 60 + CASES["zipf"][:3000]


def test_arithmetic_under_lz78_and_lzss_fails_in_both_packages():
    """lz78 feeds its coder no literals, so the arithmetic coder's codebook
    is empty and its first literal divides by zero; lzss_lcp's container
    (the same bytes in both packages) does not decode."""
    with pytest.raises(ZeroDivisionError):
        jax_compress("lz78(coder=arithmetic)", _HOST_DATA)
    with pytest.raises(ZeroDivisionError):
        compress("lz78(coder=arithmetic)", _HOST_DATA, device="cpu")
    algo = "lzss_lcp(coder=arithmetic)"
    want = jax_compress(algo, _HOST_DATA)
    assert compress(algo, _HOST_DATA, device="cpu") == want
    with pytest.raises(IndexError):
        jax_decompress(want)
    with pytest.raises(IndexError):
        decompress(want, device="cpu")


def test_sle_under_lz78_fails_in_both_packages():
    """lz78 feeds its coder no literals, so the sle coder's ranking is
    empty and its first literal finds no rank, in both packages."""
    with pytest.raises(KeyError):
        jax_compress("lz78(coder=sle)", _HOST_DATA)
    with pytest.raises(KeyError):
        compress("lz78(coder=sle)", _HOST_DATA, device="cpu")


@pytest.mark.parametrize("algo", _host_ids())
def test_host_ids_match_jax_package(algo):
    """The port's copies of the host layers write the JAX package's bytes
    for every registered id, and each package decodes the other's
    container."""
    want = jax_compress(algo, _HOST_DATA)
    got = compress(algo, _HOST_DATA, device="cpu")
    assert got == want
    assert decompress(want, device="cpu") == _HOST_DATA
    assert jax_decompress(got) == _HOST_DATA


def _imports(path):
    """Every module that `path` imports, relative imports resolved."""
    tree = ast.parse(open(path).read(), path)
    pkg = os.path.relpath(os.path.dirname(path), ROOT).replace(os.sep, ".").split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[: len(pkg) - node.level + 1] if node.level else []
            yield ".".join([*base, node.module] if node.module else base)


def test_port_imports_nothing_of_the_jax_package():
    """The port and chip_smoke.py import neither jax nor tudocomp_tpu, not
    even its jax-free modules (function-level imports included)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tudocomp_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 45
    for module in ("probes.py", "ops/transforms_torch.py", "ops/mtf_cuda.py", "compressors/chain.py",
                   "compressors/bwt.py", "compressors/lzss.py", "compressors/repair.py",
                   "ds/suffix_tree.py", "ds/binary_suffix_tree.py", "ds/naiv_st.py", "compressors/lz78u.py",
                   "compressors/lfs.py", "compressors/lfs2.py", "generators/generators.py",
                   "logging_setup.py", "stats/phase.py", "__main__.py", "parallel/distributed.py",
                   "registry_config.py"):
        assert any(p.endswith(os.path.join("tudocomp_tpu_torch", module)) for p in paths), module
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in paths
        for m in _imports(p)
        if m.split(".")[0] in ("jax", "jaxlib", "tudocomp_tpu")
    ]
    assert not bad, bad
    # the C, C++ and CUDA sources include only system headers and each
    # other, nothing of the JAX package's native/ directory
    csrc = os.path.join(ROOT, "tudocomp_tpu_torch", "csrc")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(csrc) for f in fs if f.endswith((".c", ".cpp", ".cu", ".h"))]
    assert os.path.join(csrc, "host", "tdc_memhook.c") in sources
    for src in sources:
        for line in open(src):
            if line.lstrip().startswith("#include") and '"' in line:
                name = line.split('"')[1]
                assert os.path.isfile(os.path.join(os.path.dirname(src), name)), (src, name)
                assert "native" not in name and "tudocomp_tpu" not in name, (src, name)


@pytest.mark.parametrize(
    "algo",
    ["encode(huff)", "lz78(coder=bit)", "lz78(coder=gamma)", "lzw(coder=bit)",
     "blockwise(encode(huff),bs=1024,shared=1)", "lzss_lcp(coder=huff)",
     "lzss_lcp(coder=gamma,textds=textds(isa=sparse_isa))",
     "lcpcomp(coder=huff,comp=heap)", "lcpcomp(coder=sle,comp=plcppeaks,dec=QueueListBuffer)"],
)
def test_host_path_without_the_cpp_helpers(algo, monkeypatch):
    """Where g++ is missing the port's host layers take their Python paths
    (native.get_lib() is None): the same bytes, the same roundtrip."""
    from tudocomp_tpu_torch import native

    data = CASES["deep-skew"][:3000] + b"abracadabra " * 100
    want = compress(algo, data, device="cpu")
    assert native.get_lib() is not None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.get_lib() is None
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data


@pytest.mark.parametrize(
    "spec",
    ["encode(huff)", "lz78(coder=bit)", "lzss_lcp(coder=huff,threshold=4)", "blockwise(encode(huff),bs=4096)",
     "esp", ("LZ78Compressor", "coder=gamma"), ("LZSSLCPCompressor", "coder=huff")],
)
def test_create_algo_matches_jax_package(spec):
    """registry.create_algo selects what the JAX package's does: the same
    class and the same evaluated id, from an id string or a class with an
    options string; the port's instance is bound to the device asked for."""
    from tudocomp_tpu import registry as jax_registry
    from tudocomp_tpu.compressors import lz78 as jax_lz78, lzss_lcp as jax_lzss_lcp
    from tudocomp_tpu_torch import registry
    from tudocomp_tpu_torch.compressors import lz78, lzss_lcp

    if isinstance(spec, tuple):
        name, options = spec
        port_cls = getattr(lz78 if name.startswith("LZ78") else lzss_lcp, name)
        jax_cls = getattr(jax_lz78 if name.startswith("LZ78") else jax_lzss_lcp, name)
        got = registry.create_algo(port_cls, options, device="cpu")
        want = jax_registry.create_algo(jax_cls, options)
    else:
        got = registry.create_algo(spec, device="cpu")
        want = jax_registry.create_algo(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.env.av.id_string() == want.env.av.id_string()
    assert got.env.registry.device == torch.device("cpu")


def test_paranoid_kraft_check_raises_in_both_packages(monkeypatch):
    """With paranoid.ENABLED on, a Huffman table whose code lengths break
    Kraft's equality (every length one longer) raises in both packages'
    coders; with the true lengths both pass."""
    from tudocomp_tpu import paranoid as jax_paranoid
    from tudocomp_tpu.coders import huffman as jax_huffman
    from tudocomp_tpu_torch import paranoid
    from tudocomp_tpu_torch.coders import huffman

    data = CASES["zipf"][:3000]
    for mod in (paranoid, jax_paranoid):
        monkeypatch.setattr(mod, "ENABLED", True)
    assert compress("encode(huff)", data, device="cpu") == jax_compress("encode(huff)", data)
    for mod in (huffman, jax_huffman):
        true_lengths = mod.gen_codelengths
        monkeypatch.setattr(mod, "gen_codelengths", lambda counts, f=true_lengths: f(counts) + 1)
    with pytest.raises(AssertionError, match="PARANOID: Kraft"):
        compress("encode(huff)", data, device="cpu")
    with pytest.raises(AssertionError, match="PARANOID: Kraft"):
        jax_compress("encode(huff)", data)
    paranoid.check_sorted(np.arange(5), "a range")
    with pytest.raises(AssertionError, match="not sorted"):
        paranoid.check_sorted(np.array([2, 1]), "a pair")
    with pytest.raises(AssertionError, match="PARANOID: a message"):
        paranoid.check(False, "a message")
