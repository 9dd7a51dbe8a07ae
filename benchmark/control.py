"""The controls of the benchmark's check: the program made to break one
guarantee that the configuration states, at the cell's own size, each
file of each seed coded once each way, then judged by the check that
judges the benchmark's runs (sfqbench/check.py). Every control has to
come out not correct. The benchmark's own runs never run this.

- ``lossy``: the guarantee ``lossless``. The program is handed each file
  with its qualities binned to Illumina's eight levels (the lossy
  quality coding a FASTQ compressor may offer for ratio and speed), and
  what it gives back is held to the file itself.
- ``format``: the guarantee ``format``. The program codes QUAL at an
  adaptation rate one below the configuration's, a geometry its header
  can name and its decoder follows, so the round trip stays exact while
  the container is not the format's.
- ``none``: the program as the configuration states it (the sound
  reading beside the controls').

    python3 benchmark/control.py --workload <name> --seeds 1,2,3
        --control lossy|format|none

Prints one JSON line a seed: the numbers compared, their limits and
whether the run would read correct.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

# Illumina's eight-level quality binning (Phred): each value to its bin's
_BINS = [(0, 1, 0), (2, 2, 2), (3, 9, 6), (10, 19, 15), (20, 24, 22),
         (25, 29, 27), (30, 34, 33), (35, 39, 37), (40, 93, 40)]


def binned(fastq: bytes) -> bytes:
    """The file with every quality byte binned."""
    from reference.check import fastq_records
    _, qoff, lens = fastq_records(fastq)
    lut = np.arange(256, dtype=np.uint8)
    for lo, hi, to in _BINS:
        lut[33 + lo:34 + hi] = 33 + to
    out = np.frombuffer(fastq, dtype=np.uint8).copy()
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    idx = np.repeat(qoff - starts, lens) + np.arange(int(lens.sum()))
    out[idx] = lut[out[idx]]
    return out.tobytes()


def overrides(cell, control: str) -> dict:
    if control != "format":
        return {}
    from dataclasses import replace

    from slimfastq_tpu_torch.config import config_for_level
    q = config_for_level(cell.config["level"]).qual
    return {"qual": replace(q, rate=q.rate - 1)}


def run_control(cell, seed: int, control: str, device: str = "cuda",
                system=None) -> dict:
    """One seed's files through the program under ``control``, judged."""
    from sfqbench.check import Judge
    from sfqbench.loop import Call
    from sfqbench.system import System
    files = cell.generator().make_files(cell.traffic, seed)
    system = system or System(cell.config, cell.chips, device,
                              **overrides(cell, control))
    calls, judge = [], Judge(files)
    for i, data in enumerate(files):
        given = binned(data) if control == "lossy" else data
        for kind, fn, arg in (("encode", system.encode, given),
                              ("decode", system.decode, None)):
            call = Call(kind, i, len(data), 0.0)
            t = time.perf_counter()
            try:
                call.out = fn(arg if kind == "encode" else calls[-1].out)
            except Exception as e:  # noqa: BLE001 - a failed call counts
                call.error = f"{type(e).__name__}: {e}"
            call.wall_s = time.perf_counter() - t
            calls.append(call)
            judge(call)
    ref_device = system.cuda[0] if system.cuda else "cpu"
    numbers, found = judge.numbers(cell.config, seed, ref_device)
    return {"seed": seed, "control": control,
            "numbers": {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()},
            "correct": all(v <= lim for v, lim in numbers.values())
            and not any(c.error for c in calls),
            "errors": [c.error for c in calls if c.error][:2],
            "faults": found["faults"][:4],
            "walls": [round(c.wall_s, 3) for c in calls]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", choices=("lossy", "format", "none"),
                   required=True)
    args = p.parse_args(argv)
    import torch

    from sfqbench.manifest import Cell
    from sfqbench.system import System
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("control.py: the cell's cards are not here", file=sys.stderr)
        return 2
    system = System(cell.config, cell.chips, "cuda",
                    **overrides(cell, args.control))
    for seed in args.seeds.split(","):
        print(json.dumps(run_control(cell, int(seed), args.control,
                                     system=system)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
