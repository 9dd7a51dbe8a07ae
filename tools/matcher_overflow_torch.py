#!/usr/bin/env python3
"""Whether the port's native matcher refuses an arena past 2^29 entries
cleanly: tools/longread_l4_torch.py (the 65,536 x 16.5 kb block at level
4) in a child process with SFQ_MATCH_SAMPLE_MASK=0, so that every K-mer
position of the block's ~1.08 Gbase is sampled (about twice the 2^29
entries the candidate arena's block field holds; the default mask reaches
~147 M). A clean refusal is the child exiting with a Python
`OverflowError` (no hang, no signal, no container written).

Prints one JSON line (`matcher_overflow`): the child's exit code or
signal, its seconds, its peak RSS (getrusage of the children), whether
its error output names OverflowError, and the last lines of it.

Usage: python3 tools/matcher_overflow_torch.py [--limit SECONDS]
       [-- arguments for longread_l4_torch.py]
Runs on the card only (exits 1 without one), as longread_l4_torch.py.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=float, default=1500.0)
    ap.add_argument("rest", nargs="*")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("matcher_overflow: no CUDA device", file=sys.stderr)
        return 1
    env = dict(os.environ, SFQ_MATCH_SAMPLE_MASK="0")
    cmd = [sys.executable, os.path.join(HERE, "longread_l4_torch.py"),
           *a.rest]
    t = time.perf_counter()
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=a.limit)
        hung = False
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        hung = True
    secs = time.perf_counter() - t
    rc = p.returncode
    peak_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    tail = (err or "").strip().splitlines()[-6:]
    res = {"returncode": rc, "signal": (signal.Signals(-rc).name
                                        if rc is not None and rc < 0
                                        else None),
           "hung": hung, "seconds": secs, "peak_rss_gb": peak_kb / 1e6,
           "overflow_error": any("OverflowError" in ln for ln in tail),
           "stdout_tail": (out or "").strip().splitlines()[-3:],
           "stderr_tail": tail}
    res["clean"] = (not hung and rc == 1 and res["overflow_error"])
    print(json.dumps({"matcher_overflow": res}), flush=True)
    return 0 if res["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
