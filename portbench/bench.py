"""The manifest and the parts it names, found by name.

`BENCHMARK.json` at the checkout's root lists the cells; each cell names a
configuration (the file that the manifest's `configs` entry gives) and a
traffic mix. Everything else is found in the benchmark's folder, the
first of the manifest's `paths`, by the name the data gives it:

    traffic/<mix>.json        the loop, its operations, files and clients
    corpora/<corpus>.py       generate(seed, index, size) -> bytes
    reference/<family>.py     compress(algorithm, data, config, device) -> bytes
    metrics/<metric>.py       LAYER, UNIT, SOURCE, MOVES, read(run) -> float | None

so that a new cell, configuration, mix, corpus, reference family or
per-layer metric is new files and new entries, and no edit of code.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys


class Bench:
    """One checkout's manifest, rooted at `root`."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)
        self.dir = os.path.join(self.root, self.manifest["paths"][0])

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.dir, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports (every one without a
        `workloads` list, and those whose list names the cell)."""
        return [m for m in self.manifest["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell's traced run reads."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [
            m for m in self.manifest["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in moved
        ]

    def module(self, kind: str, name: str):
        """portbench/<kind>/<name>.py, imported as a member of the package
        <kind> of this benchmark's folder (names may hold dots)."""
        pkg = f"_bench_{abs(hash(self.dir))}_{kind}"
        if pkg not in sys.modules:
            where = os.path.join(self.dir, kind)
            spec = importlib.util.spec_from_file_location(
                pkg, os.path.join(where, "__init__.py"), submodule_search_locations=[where]
            )
            mod = importlib.util.module_from_spec(spec)
            sys.modules[pkg] = mod
            spec.loader.exec_module(mod)
        full = f"{pkg}.{name.replace('.', '__')}"
        if full not in sys.modules:
            path = os.path.join(self.dir, kind, f"{name}.py")
            spec = importlib.util.spec_from_file_location(full, path)
            if spec is None or not os.path.exists(path):
                raise KeyError(f"no {kind} {name!r}: {path} is missing")
            mod = importlib.util.module_from_spec(spec)
            mod.__package__ = pkg
            sys.modules[full] = mod
            spec.loader.exec_module(mod)
        return sys.modules[full]

    def entry(self, spec: str):
        """'package.module:function' -> the function."""
        mod, fn = spec.split(":")
        return getattr(importlib.import_module(mod), fn)
