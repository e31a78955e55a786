"""Library entry points of the port: compress / decompress with an `id%` header.

The same flow as tudocomp_tpu/driver.py (tudocomp_driver.cpp:252-345): on
compress, write the id string and '%', wrap the input with the
compressor's restrictions and run it; on decompress, read the header up to
'%' (at most 1023 bytes), select the algorithm, wrap the output and run it.
The algorithms come from a TorchRegistry bound to `device`, or from the
`registry` given, whose device then wins. Each call logs its algorithm at
INFO on the `tudocomp_tpu_torch.driver` logger (the command line's
--loglevel 0).
"""

from __future__ import annotations

import logging
from typing import Optional

from .io.inout import Input, Output
from .registry import TorchRegistry

__all__ = ["compress", "decompress"]

_LOG = logging.getLogger("tudocomp_tpu_torch.driver")


def compress(
    id_string: str, data, device="cuda", raw: bool = False, registry: Optional[TorchRegistry] = None
) -> bytes:
    reg = registry or TorchRegistry(device)
    av = reg.parse_algorithm_id(id_string, "compressor")
    comp = reg.select_algorithm(av, "compressor")
    rest = comp.meta().input_restrictions
    _LOG.info("compress: algorithm %s on %s", av.id_string(), reg.device)
    out = Output()
    if not raw:
        if "%" in id_string:
            raise ValueError("the algorithm id may not contain '%'")
        out.write(id_string.encode())
        out.write(b"%")
    inp = Input(data)
    if rest.has_restrictions:
        inp = inp.with_restrictions(rest)
    comp.compress(inp, out)
    return out.raw_value()


def decompress(
    data,
    device="cuda",
    id_string: Optional[str] = None,
    raw: bool = False,
    registry: Optional[TorchRegistry] = None,
) -> bytes:
    reg = registry or TorchRegistry(device)
    inp = Input(data)
    if not raw:
        arr = inp.raw_array()
        header = bytearray()
        for i in range(min(len(arr), 1024)):
            if arr[i] == ord("%"):
                break
            header.append(arr[i])
        else:
            raise ValueError("Input did not have an algorithm header!")
        inp = Input(arr[len(header) + 1 :])
        if id_string is None:
            id_string = header.decode()
    if id_string is None:
        raise ValueError("raw decompression needs the algorithm id")
    comp = reg.select(id_string, "compressor")
    rest = comp.meta().input_restrictions
    _LOG.info("decompress: algorithm %s on %s", id_string, reg.device)
    out = Output()
    wrapped = out.with_restrictions(rest) if rest.has_restrictions else out
    comp.decompress(inp, wrapped)
    return wrapped.getvalue()
