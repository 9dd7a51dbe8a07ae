"""One run of one cell of the benchmark of slimfastq_tpu_torch.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up makes the cell's FASTQ files from the seed (traffic/), builds
the system on the cell's cards (the port builds its kernels into its own
directories in the checkout on the first run there), and codes each file
once to warm up. The window then runs a closed loop of one client:
encode a file to a container in memory, decode the container, the next
file, until the first call that ends past ``--seconds``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from host-stage clocks and a
device trace of every call. Then every output of the window is checked
(sfqbench/check.py), each compared number printed beside its limit on
standard error and in the last key of the result line, the last line of
standard output. Without the cell's cards, or with JAX or the JAX package
loaded, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# JAX must not come in through a library the port loads
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# any kernel cache a library keeps stays at a fixed path in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "slimfastq_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: slimfastq_tpu_torch is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, **overrides) -> dict:
    """Set up, run the window and check it; returns the result."""
    from contextlib import nullcontext

    import torch

    from sfqbench.check import Judge
    from sfqbench.loop import closed_loop
    from sfqbench.record import Run
    from sfqbench.roofline import block_shapes
    from sfqbench.system import System
    files = cell.generator().make_files(cell.traffic, seed)
    system = System(cell.config, cell.chips, device, **overrides)
    for data in files:  # warm-up: every shape the window uses
        system.decode(system.encode(data))
    system.sync()
    metrics = cell.metrics(bool(trace))
    runner = stages = None
    if trace:
        from sfqbench.stages import Stages
        from sfqbench.trace import Profiled
        stages = Stages([s for _, m in metrics for s in getattr(
            m, "STAGES", ())], {k: v for _, m in metrics
                                for k, v in getattr(m, "WAITS", {}).items()})
        runner = Profiled(stages, system.sync)
    judge = Judge(files)
    setup_s = time.perf_counter() - t0
    with stages or nullcontext():
        calls = closed_loop(files, system.encode, system.decode, seconds,
                            around=runner, sync=system.sync, after=judge)
    peak = system.memory_peak_bytes()
    name = (torch.cuda.get_device_name(system.cuda[0]) if system.cuda
            else "cpu")
    ref_device = system.cuda[0] if system.cuda else "cpu"
    del system  # the program's state, before the check
    numbers, found = judge.numbers(cell.config, seed, ref_device)
    shapes = {}
    if trace and not found["faults"]:
        shapes = {f: block_shapes(data, files[f], cell.config)
                  for f, data in judge.held.items()}
    run = Run(calls, setup_s, name, cell.chips, shapes)
    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = sum(1 for c in calls if c.error is not None)
    ok = failed == 0 and all(v <= lim for v, lim in numbers.values()) \
        and run.done("encode") and run.done("decode")
    device_info = {"platform": "gpu" if name != "cpu" else "cpu",
                   "kind": name, "count": cell.chips,
                   "memory_peak_bytes": peak}
    res = {"correct": bool(ok), "attempted": len(calls), "failed": failed,
           "metrics": values, "device": device_info}
    if trace:
        traced = [c for c in calls if c.trace]
        device_info["busy_s"] = sum(sum(c.trace["busy_s"].values())
                                    for c in traced) / cell.chips
        device_info["window_s"] = sum(c.trace["window_s"] for c in traced)
        ops, gaps = {}, {}
        for c in traced:
            for k, v in c.trace["kernels"].items():
                ops[f"{c.kind}.{k}"] = ops.get(f"{c.kind}.{k}", 0.0) + v
            for k, v in c.trace["gaps"].items():
                gaps[k] = gaps.get(k, 0.0) + v
        res["breakdown"] = {
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    res["_notes"] = {"walls": [f"{c.kind[0]}{c.wall_s:.3f}" for c in calls],
                     "errors": [c.error for c in calls if c.error][:3],
                     "faults": found["faults"][:10],
                     "lanes_compared": found["lanes"],
                     "reference_s": found["seconds"],
                     "ratio": (sum(len(files[f]) for f in judge.held) / max(
                         1, sum(len(d) for d in judge.held.values())))}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from sfqbench.manifest import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s), this "
              f"machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    notes = res.pop("_notes")
    print(f"compression ratio {notes['ratio']:.4f}; lanes compared "
          f"{notes['lanes_compared']} in {notes['reference_s']:.1f} s; errors {notes['errors']}; format "
          f"faults {notes['faults']}", flush=True)
    print("call walls (s): " + " ".join(notes["walls"]), flush=True)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
