"""The port's process group on the CPU: gloo ranks against one process and
against the JAX package.

The twin of tests/test_distributed_multiprocess.py. The ranks are
subprocesses of the port alone (each asserts at its end that neither jax
nor tudocomp_tpu was imported) on device="cpu", where the kernels' plain
versions run. Two ranks from TDC_NUM_PROCESSES / TDC_PROCESS_ID /
TDC_COORDINATOR run pod_compress with the huff inner (per block and
shared=1) and the lzss inner (shared 0 and 1), and driver.compress of the
multiproc arm, blockwise(lzss_lcp(coder=huff)) without shared, and of a
nested blockwise(blockwise(encode(huff))); three ranks from torchrun's
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT run the runtime over two
blocks (one rank has none) and over empty input. Every container must
equal the JAX package's one-process runtime (or driver) and the port's
one-process run, on every rank, and both packages' decoders must return
the input. Tolerance: exact equality (bytes). Each launch of ranks runs
every case of its kind, so the file takes a few rank launches.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.parallel import runtime as jax_runtime
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.parallel import distributed, runtime
from tudocomp_tpu_torch.parallel.blocks import unframe_streams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4096
LZSS = "lzss_lcp(coder=huff)"

# every rank runs each case; pod_compress's cases keep rank 0's container and
# check None on the others, the rest keep every rank's container
WORKER = """
import os, sys
from tudocomp_tpu_torch.driver import compress
from tudocomp_tpu_torch.parallel import runtime
from tudocomp_tpu_torch.parallel.distributed import group, init_distributed, pod_compress

assert init_distributed(timeout_s=120)
world, rank = group()
assert world == int(sys.argv[2]), (world, sys.argv[2])
out = sys.argv[1]


def save(name, blob):
    with open(os.path.join(out, f"{name}.{rank}.bin"), "wb") as f:
        f.write(blob)


inputs = {}
for name in sorted(os.listdir(out)):
    if name.endswith(".input"):
        with open(os.path.join(out, name), "rb") as f:
            inputs[name[: -len(".input")]] = f.read()
for case in sys.argv[3:]:
    kind, which = case.split(":")
    data = inputs[which]
    if kind.startswith("pod-"):
        inner, shared = kind[4:].split("-")
        got = pod_compress(data, %(bs)d, shared_table=shared == "1", inner=inner, device="cpu")
        assert (got is None) == (rank != 0), (case, rank)
        if rank == 0:
            save(case, got)
    elif kind.startswith("run-"):
        inner, shared = kind[4:].split("-")
        fn = runtime.blockwise_lzss_compress if inner == "lzss" else runtime.blockwise_huffman_compress
        save(case, fn(data, %(bs)d, "cpu", shared_table=shared == "1"))
    else:
        save(case, compress(kind, data, device="cpu"))
assert "jax" not in sys.modules and "tudocomp_tpu" not in sys.modules, "the port imported jax"
print("rank", rank, "done")
""" % {"bs": BS}

MULTIPROC = f"blockwise({LZSS},bs={BS})"
NESTED = "blockwise(blockwise(encode(huff)),bs=8192)"
TWO_RANKS = ["pod-huff-0:mixed", "pod-huff-1:mixed", "pod-lzss-0:mixed", "pod-lzss-1:mixed",
             f"{MULTIPROC}:mixed", f"{NESTED}:mixed"]
THREE_RANKS = [f"run-{inner}-{shared}:{which}" for inner in ("huff", "lzss") for shared in "01"
               for which in ("two-blocks", "empty")]


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "mixed": (b"distributed block parallel " * 800) + bytes(rng.integers(0, 256, 5000).astype(np.uint8)),
        "two-blocks": bytes(rng.zipf(1.5, BS + 100).clip(0, 255).astype(np.uint8)),
        "empty": b"",
    }


INPUTS = _inputs()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, world: int, cases, env_of) -> dict:
    """Run WORKER in `world` ranks over `cases`; {(case, rank): bytes}."""
    for name, data in INPUTS.items():
        (tmp / f"{name}.input").write_bytes(data)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("TDC_NUM_PROCESSES", "TDC_PROCESS_ID", "TDC_COORDINATOR", "RANK", "WORLD_SIZE",
                            "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "TDC_BLOCKWISE_PROCS")
               and not k.startswith("TDC_DEVICE_")}
        env.update(env_of(rank, world, port), PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(tmp), str(world), *cases], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so[-2000:]}\n{se[-3000:]}"
    got = {}
    for case in cases:
        for rank in range(world):
            f = tmp / f"{case}.{rank}.bin"
            if f.exists():
                got[case, rank] = f.read_bytes()
    return got


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    def env_of(rank, world, port):
        return {"TDC_NUM_PROCESSES": str(world), "TDC_PROCESS_ID": str(rank), "TDC_COORDINATOR": f"127.0.0.1:{port}"}

    return _launch(tmp_path_factory.mktemp("two"), 2, TWO_RANKS, env_of)


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    def env_of(rank, world, port):  # as torchrun sets it
        return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port)}

    return _launch(tmp_path_factory.mktemp("three"), 3, THREE_RANKS, env_of)


def _check_decodes(container: bytes, inner: str, data: bytes) -> None:
    _, payloads = unframe_streams(container)
    if inner == "huff":
        assert runtime.blockwise_huffman_decompress(container, "cpu") == data
        inner_id = "encode(huff)"
    else:
        inner_id = LZSS
    assert b"".join(decompress(p, device="cpu", id_string=inner_id, raw=True) for p in payloads) == data
    assert b"".join(jax_decompress(p, id_string=inner_id, raw=True) for p in payloads) == data


def _references(inner: str, shared: bool, data: bytes) -> tuple:
    """(the JAX package's one-process runtime, the port's one-process runtime)."""
    if inner == "huff":
        return (jax_runtime.blockwise_huffman_compress(data, BS, shared_table=shared),
                runtime.blockwise_huffman_compress(data, BS, "cpu", shared_table=shared))
    return (jax_runtime.blockwise_lzss_compress(data, BS, shared_table=shared),
            runtime.blockwise_lzss_compress(data, BS, "cpu", shared_table=shared))


@pytest.mark.parametrize("case", TWO_RANKS[:4])
def test_two_ranks_pod_compress(two_ranks, case):
    kind, which = case.split(":")
    inner, shared = kind[4:].split("-")
    data = INPUTS[which]
    got = two_ranks[case, 0]
    assert (case, 1) not in two_ranks  # rank 1 got None
    want_jax, want_port = _references(inner, shared == "1", data)
    assert got == want_jax
    assert got == want_port
    assert len(unframe_streams(got)[1]) == 7  # 4 blocks on rank 0, 3 on rank 1
    _check_decodes(got, inner, data)


@pytest.mark.parametrize("algo", [MULTIPROC, NESTED])
def test_driver_in_each_rank(two_ranks, algo, monkeypatch):
    """driver.compress in a group: the multiproc arm (lzss_lcp(coder=huff)
    to the runtime without shared=1) and the nested blockwise, whose inner
    blocks reach the runtime's group arm (rank 1 holds none of them)."""
    data = INPUTS["mixed"]
    case = f"{algo}:mixed"
    assert two_ranks[case, 0] == two_ranks[case, 1]
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "0")  # read by both packages: no pool in this process
    want = jax_compress(algo, data)
    assert two_ranks[case, 0] == want
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data
    assert jax_decompress(two_ranks[case, 0]) == data


@pytest.mark.parametrize("case", THREE_RANKS)
def test_three_ranks_few_blocks(three_ranks, case):
    """Three ranks over two blocks (rank 2 has none) and over empty input
    (one empty block: ranks 1 and 2 have none): every rank joins every
    collective and frames the same bytes."""
    kind, which = case.split(":")
    inner, shared = kind[4:].split("-")
    data = INPUTS[which]
    got = {three_ranks[case, r] for r in range(3)}
    assert len(got) == 1
    got = got.pop()
    want_jax, want_port = _references(inner, shared == "1", data)
    assert got == want_jax
    assert got == want_port
    _check_decodes(got, inner, data)


def test_one_process_has_no_group(monkeypatch):
    for var in ("TDC_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.init_distributed(num_processes=1, process_id=0) is False
    assert distributed.group() == (1, 0)
    monkeypatch.setenv("TDC_NUM_PROCESSES", "2")
    monkeypatch.setenv("TDC_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="not a rank"):
        distributed.init_distributed()


def test_rank_device():
    import torch

    assert distributed.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.rank_device("cuda")
    with pytest.raises(ValueError, match="unknown inner"):
        distributed.pod_compress(b"x", inner="lz78", device="cpu")
