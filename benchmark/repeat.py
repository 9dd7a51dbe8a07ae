"""Run one cell several times, each run a fresh process of run.py, and
print each run's result and, per metric, the median and the spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median).

    python3 benchmark/repeat.py --workload <name> --seeds 11,12,13
        --seconds <s> [--trace 0|1] [--out FILE]

The card's name and power limit are printed first (nvidia-smi). With
``--out`` each run's result line is appended to FILE as JSON with its
seed, exit code and the end of its standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip().replace("\n", " | "), flush=True)
    got: dict = {}
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                            "--workload", args.workload, "--seed", seed,
                            "--seconds", str(args.seconds), "--trace",
                            str(args.trace)], capture_output=True, text=True)
        took = time.perf_counter() - t
        lines = r.stdout.strip().splitlines()
        res = None
        if r.returncode == 0 and lines:
            res = json.loads(lines[-1])
        rec = {"workload": args.workload, "seed": int(seed),
               "trace": args.trace, "rc": r.returncode, "took_s": took,
               "result": res, "stdout_head": lines[:-1][-3:],
               "stderr_tail": r.stderr[-3000:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("seed", "rc", "took_s")}),
              flush=True)
        if res is None:
            print(r.stderr[-3000:], flush=True)
            continue
        print("\n".join(lines[:-1][-2:]), flush=True)
        print(json.dumps(res), flush=True)
        for k, m in res["metrics"].items():
            got.setdefault(k, []).append(m["value"])
    for k, vals in got.items():
        print(json.dumps({"metric": k, "n": len(vals),
                          "median": statistics.median(vals),
                          "spread": spread(vals), "values": vals}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
