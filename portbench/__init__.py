"""The benchmark of the PyTorch and CUDA port (`tudocomp_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on one card; README.md says how it works
and how a cell, a configuration, a traffic mix or a metric is added.
"""
