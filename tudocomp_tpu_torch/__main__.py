"""Command line of the port: tdc's flags, on one NVIDIA GPU.

The port's copy of tudocomp_tpu/__main__.py (mirror of the reference CLI,
src/tudocomp_driver/tudocomp_driver.cpp:52-398 and
include/tudocomp_driver/Options.hpp:15-306): compresses or decompresses a
file, stdin, or a generated string; writes the self-describing `<id>%`
header; `--stats` prints the Charter JSON {meta, data} document.

Usage:  python -m tudocomp_tpu_torch [OPTION] FILE
   or:  python -m tudocomp_tpu_torch [OPTION] --usestdin
   or:  python -m tudocomp_tpu_torch [OPTION] -g GENERATOR

Every flag of the JAX package's command line, and `--device cuda|cpu`
(default cuda: the run's device stages go to the card, and with no card
the run raises; cpu runs the host paths). With `--stats` on a card the
phases carry that card's memory (devMemOff, devMemPeak, devMemFinal).
TDC_MALLOC_HOOK=1 re-execs the command once with the malloc interposer
(csrc/host/tdc_memhook.c, built with g++ at first use; a build that fails
raises) in LD_PRELOAD, for byte-accurate host heap columns; where the
re-exec'd process still finds no interposer (the loader dropped the
preload), it does not re-exec again and the columns come from tracemalloc,
as in the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

COMPRESSED_FILE_ENDING = "tdc"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tudocomp_tpu_torch",
        description=(
            "Compresses or decompresses a file (1), an input received via "
            "stdin (2) or a generated string (3), on one NVIDIA GPU."
        ),
        epilog=(
            "TDC_MALLOC_HOOK=1 re-execs once with the malloc interposer in "
            "LD_PRELOAD (built with g++ at first use; a failed build raises) "
            "for byte-accurate --stats heap columns; if the re-exec'd process "
            "finds no interposer, the columns come from tracemalloc."
        ),
        add_help=False,
    )
    p.add_argument("-a", "--algorithm", metavar="ALGORITHM", default="", help="the algorithm id")
    p.add_argument("-d", "--decompress", action="store_true", help="decompress the input")
    p.add_argument("-f", "--force", action="store_true", help="overwrite an existing output file")
    p.add_argument("-g", "--generator", metavar="GENERATOR", default="", help="generate the input, e.g. fib(n=20)")
    p.add_argument("-l", "--list", action="store_true", help="list the algorithms")
    p.add_argument("-o", "--output", metavar="FILE", default="", help="the output file")
    p.add_argument("-s", "--stats", nargs="?", const="", default=None, metavar="TITLE",
                   help="print the phases' time and memory as Charter JSON")
    p.add_argument("-v", "--version", action="store_true", help="print the version")
    p.add_argument("--help", action="store_true", help="print this help")
    p.add_argument("--raw", action="store_true", help="no algorithm header")
    p.add_argument("--usestdin", action="store_true", help="read the input from stdin")
    p.add_argument("--usestdout", action="store_true", help="write the output to stdout")
    p.add_argument("--logdir", default=None, help="also log to a file in this directory")
    p.add_argument("--loglevel", default=None, help="0-3: INFO, WARNING, ERROR, CRITICAL")
    p.add_argument("--logverbosity", default=None, help="> 0: DEBUG, with each phase's time")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("file", nargs="?", default="")
    return p


def bad_usage(msg: str) -> int:
    print(f"Error: {msg}", file=sys.stderr)
    print("Try --help for more information.", file=sys.stderr)
    return 1


def _maybe_reexec_with_memhook() -> None:
    """TDC_MALLOC_HOOK=1: re-exec with the malloc interposer preloaded. No-op
    when it is preloaded already, or when this process is the re-exec
    (TDC_MEMHOOK_REEXEC=1) and the preload did not take: then tracemalloc
    gives the columns, and nothing re-execs a second time."""
    if os.environ.get("TDC_MALLOC_HOOK") != "1":
        return
    from .native import memhook_counters, memhook_so_path

    if memhook_counters() is not None or os.environ.get("TDC_MEMHOOK_REEXEC") == "1":
        return
    so = memhook_so_path()  # raises where it cannot be built
    env = dict(os.environ)
    pre = env.get("LD_PRELOAD", "")
    env["LD_PRELOAD"] = f"{so}:{pre}" if pre else so
    env["TDC_TRACK_MEM"] = env.get("TDC_TRACK_MEM", "1")
    env["TDC_MEMHOOK_REEXEC"] = "1"
    os.execve(sys.executable, [sys.executable, "-m", "tudocomp_tpu_torch"] + sys.argv[1:], env)


def main(argv=None) -> int:
    if argv is None:
        _maybe_reexec_with_memhook()
    args = build_parser().parse_args(argv)

    if args.help:
        build_parser().print_help()
        return 0
    if args.version:
        from . import __version__

        print(f"tdc (tudocomp_tpu_torch) {__version__}")
        return 0

    from .logging_setup import setup_logging
    from .stats.phase import StatPhase

    setup_logging(args.logdir, args.loglevel, args.logverbosity)

    @functools.lru_cache(maxsize=None)
    def make_registry():
        # imports torch, so a usage error is reported without it; with
        # --device cuda and no card, TorchRegistry raises
        from .registry import TorchRegistry

        registry = TorchRegistry(args.device)
        if args.stats is not None and registry.device.type == "cuda":
            StatPhase.track_device = registry.device
        return registry

    if args.stats is not None and os.environ.get("TDC_TRACK_MEM") != "0":
        StatPhase.track_memory = True

    if args.list:
        registry = make_registry()
        print("This build supports the following algorithms:")
        print()
        for t in registry.types():
            print(registry.generate_doc_string(t))
            print()
        return 0

    do_compress = not args.decompress

    # -- select input ---------------------------------------------------------
    n_inputs = bool(args.usestdin) + bool(args.generator) + bool(args.file)
    if n_inputs > 1:
        return bad_usage("trying to use multiple inputs")
    if n_inputs == 0:
        return bad_usage("no input given")
    if args.generator and not do_compress:
        return bad_usage("trying to decompress generated string")

    start_time = time.time()
    if args.usestdin:
        data = sys.stdin.buffer.read()
        in_name = "<stdin>"
    elif args.generator:
        data = make_registry().select(args.generator, "generator").generate()
        in_name = args.generator
    else:
        if not os.path.isfile(args.file):
            print(f"input path not found or is not a file: {args.file}", file=sys.stderr)
            return 1
        with open(args.file, "rb") as f:
            data = f.read()
        in_name = args.file
    in_size = len(data)

    # -- select output --------------------------------------------------------
    if args.output and args.usestdout:
        return bad_usage("trying to use multiple outputs")
    ofile = None
    if not args.usestdout:
        if args.output:
            ofile = args.output
        elif do_compress and args.file:
            ofile = args.file + "." + COMPRESSED_FILE_ENDING
        else:
            return bad_usage(
                "either specify a filename (-o filename) or state that the "
                "output is standard output (--usestdout)"
            )
        if os.path.exists(ofile) and not args.force:
            print(f"output file already exists: {ofile}", file=sys.stderr)
            return 1

    # -- run ------------------------------------------------------------------
    if do_compress and not args.algorithm:
        return bad_usage("compression requires an algorithm (-a)")
    if not do_compress and args.raw and not args.algorithm:
        return bad_usage("raw decompression requires an algorithm (-a)")

    from .driver import compress as do_compress_fn, decompress as do_decompress_fn

    registry = make_registry()
    config = args.algorithm
    try:
        with StatPhase("root") as root:
            if do_compress:
                result = do_compress_fn(args.algorithm, data, raw=args.raw, registry=registry)
            else:
                if not args.raw and not config:
                    # the id string for --stats comes from the header
                    head, _, _ = bytes(data[:1024]).partition(b"%")
                    config = head.decode(errors="replace")
                result = do_decompress_fn(
                    data, id_string=args.algorithm or None, raw=args.raw, registry=registry
                )
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if ofile is not None:
        with open(ofile, "wb") as f:
            f.write(result)
    else:
        sys.stdout.buffer.write(result)
        sys.stdout.buffer.flush()

    # -- stats (tudocomp_driver.cpp:361-391 JSON document) --------------------
    if args.stats is not None:
        out_size = len(result) if ofile is None else os.path.getsize(ofile)
        doc = {
            "meta": {
                "title": args.stats,
                "startTime": int(start_time),
                "config": config or "<none>",
                "input": in_name,
                "inputSize": in_size,
                "output": ofile if ofile is not None else "<stdout>",
                "outputSize": out_size,
                "rate": 0.0 if in_size == 0 else out_size / in_size,
            },
            "data": root.to_dict(),
        }
        print(json.dumps(doc))

    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
