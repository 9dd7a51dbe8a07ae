"""Shared set-up of the benchmark's CPU tests: the harness's folder and
the repository's root on the path, and a copy of the benchmark in a
temporary directory with one more, tiny cell added by files and entries
only (64 lanes, blocks of 128 records, reads of 40-80 bp), which the
program codes on the CPU with its kernels' plain versions."""

import importlib.util
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CONFIG = {"name": "tiny-l3", "lanes": 64, "aux_lanes": 16,
               "block_records": 128, "reads_per_file": 300}
TINY_TRAFFIC = {"reads": 300, "read_length": {"min": 40, "max": 80}}


def make_copy(where: str, chips: int = 1) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``where`` with the
    cell ``tiny`` added; returns the copy's benchmark folder."""
    bench = os.path.join(where, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(BENCH, "configs", "slimfastq-l3.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY_CONFIG)
    with open(os.path.join(bench, "configs", "tiny-l3.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "workloads", "illumina-1m.json")) as f:
        traffic = json.load(f)
    traffic.update(TINY_TRAFFIC)
    with open(os.path.join(bench, "workloads", "tiny.json"), "w") as f:
        json.dump(traffic, f)
    manifest["configs"].append({
        "name": "tiny-l3", "source": "a test", "reduced": [],
        "file": "benchmark/configs/tiny-l3.json", "why": "a test"})
    manifest["workloads"].append({
        "name": "tiny", "config": "tiny-l3", "traffic": "tiny",
        "chips": chips, "why": "a test"})
    for m in manifest["per_layer"]:  # as the level-3 cells
        if "l3-illumina-bulk" in m["workloads"]:
            m["workloads"].append("tiny")
    with open(os.path.join(where, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return bench


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(tmp_path):
    """(the copy's benchmark folder, its run.py module, the tiny Cell)."""
    from sfqbench.manifest import Cell
    bench = make_copy(str(tmp_path))
    run = load(os.path.join(bench, "run.py"), "bench_run_copy")
    return bench, run, Cell("tiny", bench)
