"""Multi-process initialisation and the group compression entry point.

The port of tudocomp_tpu/parallel/distributed.py on torch.distributed: one
process for each card, in PyTorch's idiom, in place of the JAX package's
device mesh. Every process runs the same program; `init_distributed()`
joins them into the default process group, after which the block-parallel
runtime (runtime.py) splits the blocks over the ranks. Each rank runs its
blocks' kernels on its own card; only a [256] histogram (all-reduced) and
the finished per-block payloads (gathered in block order) cross between
processes, and every rank frames the same TBK1 container.

Every collective runs through gloo on host tensors. What the ranks exchange
lies on the host already (the runtime copies the payloads down to frame
them), NCCL cannot put two ranks on one card, and gloo cannot all-gather
CUDA tensors. The JAX package's `dp_mesh` and `make_block_encoder` have no
twin: the process group takes the mesh's place, and a device list in one
process raises (device.resolve).

A group comes from the TDC_NUM_PROCESSES, TDC_PROCESS_ID and TDC_COORDINATOR
variables, as in the JAX package, or from torchrun's RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT; one process, or none of them set, runs
without a group.
"""

from __future__ import annotations

import atexit
import datetime
import os

import torch

from ..device import resolve

__all__ = ["group", "init_distributed", "pod_compress", "rank_device"]

DEFAULT_COORDINATOR = "127.0.0.1:8476"
# gloo's own default is 30 minutes: one dead rank would hang the others that long
TIMEOUT_S = 300


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the default process group (gloo) when running multi-process;
    no-op otherwise. Returns True if a group of more than one is active.

    Unset arguments come from TDC_NUM_PROCESSES, TDC_PROCESS_ID and
    TDC_COORDINATOR (host:port, default 127.0.0.1:8476), else from
    torchrun's WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT."""
    env = os.environ
    if num_processes is None and env.get("TDC_NUM_PROCESSES"):
        num_processes = int(env["TDC_NUM_PROCESSES"])
        process_id = int(env.get("TDC_PROCESS_ID", "0"))
        coordinator_address = coordinator_address or env.get("TDC_COORDINATOR", DEFAULT_COORDINATOR)
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        coordinator_address = coordinator_address or f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of a group of {num_processes}")
    torch.distributed.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address or DEFAULT_COORDINATOR}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    atexit.register(_leave_group)
    return True


def _leave_group() -> None:
    """Destroy the group at exit, if the program has not: a gloo group left
    to the interpreter's own teardown can abort a process whose work is
    done ("terminate called without an active exception")."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def rank_device(device="cuda") -> torch.device:
    """This process's device: the one named, or for "cuda" without an
    index card LOCAL_RANK % device_count (torchrun's local rank, else the
    group rank, else 0), or the CPU when asked. Raises as device.resolve
    does where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve(dev)  # raises where there is no card
        local = os.environ.get("LOCAL_RANK")
        rank = int(local) if local is not None else group()[1]
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve(dev)


def group() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def pod_compress(
    data, block_size: int = 1 << 18, shared_table: bool = False, inner: str = "huff", device="cuda"
) -> bytes | None:
    """Compress across the group; returns the container on rank 0 and None
    elsewhere (every rank must call this collectively with the same data).
    inner selects the block pipeline: "huff" = encode(huff), "lzss" =
    lzss_lcp(coder=huff), each rank on its blocks and its card
    (rank_device(device)), with shared_table one table from the histogram
    summed over every rank."""
    from .runtime import blockwise_huffman_compress, blockwise_lzss_compress

    dev = rank_device(device)
    if inner == "lzss":
        out = blockwise_lzss_compress(data, block_size, dev, shared_table=shared_table)
    elif inner == "huff":
        out = blockwise_huffman_compress(data, block_size, dev, shared_table=shared_table)
    else:
        raise ValueError(f"unknown inner {inner!r}: 'huff' or 'lzss'")
    return out if group()[1] == 0 else None
