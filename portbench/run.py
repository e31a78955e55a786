"""Run one cell of BENCHMARK.json on the CUDA card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers the check compared, with their limits, are the
last lines of standard error. Exits 2 without a card (or with fewer than
the cell asks for), 3 when jax, jaxlib, flax or tudocomp_tpu is loaded.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # build and kernel caches at fixed places inside the checkout (the
    # port's own nvcc and g++ builds go to build/tudocomp_tpu_torch/ there)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T0, ROOT))
