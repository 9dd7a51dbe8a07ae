"""BENCHMARK.json and the files it names: a cell is found by its name,
its configuration in ``configs/<name>.json``, its traffic mix in
``workloads/<name>.json`` (whose ``generator`` names a module of
``traffic/``) and each metric in ``metrics/<name>.py``. A later cell,
configuration, mix or metric is files and entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    def __init__(self, name: str, bench_dir: str = HERE,
                 manifest: str | None = None):
        self.dir = bench_dir
        path = manifest or os.path.join(os.path.dirname(bench_dir),
                                        "BENCHMARK.json")
        with open(path) as f:
            self.manifest = json.load(f)
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in {path}")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.run_seconds = int(self.manifest["run_seconds"])
        cfg = [c for c in self.manifest["configs"]
               if c["name"] == self.entry["config"]][0]
        with open(os.path.join(os.path.dirname(bench_dir), cfg["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(bench_dir, "workloads",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        want = self.config.get("reads_per_file")
        if want is not None and want != self.traffic["reads"]:
            raise ValueError(f"{name}: its configuration states "
                             f"{want} reads a file, its traffic "
                             f"{self.traffic['reads']}")

    def generator(self):
        return _load_module(os.path.join(
            self.dir, "traffic", self.traffic["generator"] + ".py"),
            "sfqbench_traffic_" + self.traffic["generator"])

    def metrics(self, trace: bool) -> list:
        """(entry, reader module) of the metrics this cell reports: the
        end-to-end ones in an untraced run, the per-layer ones in a
        traced run, each where its ``workloads`` names the cell or where
        it names none."""
        key = "per_layer" if trace else "end_to_end"
        out = []
        for m in self.manifest[key]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            out.append((m, _load_module(
                os.path.join(self.dir, "metrics", m["name"] + ".py"),
                "sfqbench_metric_" + m["name"].replace(".", "_"))))
        return out
