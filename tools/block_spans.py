#!/usr/bin/env python3
"""Kernels E and D on the pinned 64k block, stream by stream, for any tree
of the port (``--root``, e.g. an earlier commit unpacked with git
archive), at ``--lanes`` W (1,024, the default; a tree from before lane
counts past 1,024 takes only that) and at level 3 or, with ``--geometry
G``, at level 3 with one stream's geometry changed: G one of
chip_smoke.GEOMS (QUAL or SEQ at a visit cap of 16 or 512 in 32-bit
entries, FLAG at 17 history bits) or STREAM:KEY=V[,KEY=V] (e.g.
seq:rate=7,rate_lo=2; STREAM qual, seq, bytes_ or flags); a tree from
before those takes none:
chip_smoke.block_spans, each of the block's seven streams coded and
decoded alone on the main
path's inputs and each direction's span with its streams launched at
once. With ``--phases NAME ...`` it times instead Kernel E's six phases
one after another on the named streams (chip_smoke.phase_times: CUDA
events around each phase's launches, summed over the slices; the least of
``--reps`` runs) and E launched whole. CUDA events; prints one JSON line
(`block_spans`) with the card's name and power limit.

Usage: python3 tools/block_spans.py [--root DIR] [--lanes W]
       [--geometry NAME] [--phases NAME ... [--reps N]]
Runs on the card only (exits 1 without one). Run the parent and this tree
in turns on one card (parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--geometry", default=None)
    ap.add_argument("--phases", nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("block_spans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    _cuda.build()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    data = CS._pinned(CS.READS)
    cfg = config_for_level(3, lanes=a.lanes)
    if a.geometry:
        cfg = geometry(CS, a.geometry, a.lanes)
    if a.phases:
        out = {"phases": phases(CS, data, dev, cfg, a.phases, a.reps)}
    elif a.lanes == 1024 and not a.geometry:
        out = CS.block_spans(data, dev)
    else:
        out = CS.block_spans(data, dev, cfg, key=f"block_w{a.lanes}"
                             + (f"_{a.geometry}" if a.geometry else ""))
    print(json.dumps({"block_spans": {"root": root, "card": card,
                                      "lanes": a.lanes,
                                      "geometry": a.geometry, **out}}),
          flush=True)
    return 0


def geometry(CS, spec: str, lanes: int):
    """Level 3 at `lanes` with one stream changed: a chip_smoke.GEOMS name
    or STREAM:KEY=V[,KEY=V]."""
    from dataclasses import replace
    from slimfastq_tpu_torch.config import config_for_level
    if ":" not in spec:
        return replace(CS.geom_cfg(spec), lanes=lanes)
    field, kv = spec.split(":", 1)
    changes = {k: int(v) for k, v in (x.split("=") for x in kv.split(","))}
    cfg = config_for_level(3, lanes=lanes)
    return replace(cfg, **{field: replace(getattr(cfg, field), **changes)})


def phases(CS, data: bytes, dev, cfg, names, reps: int) -> dict:
    """{stream: {phase: least ms of `reps` runs, "e_ms": E whole}}, E's
    phases one after another on the named streams of the block."""
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.ops import streams_torch as ST
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    out = {}
    for name, kind, geom, item, _ in PN._coder_jobs(pre, cfg, dev):
        if name not in names:
            continue
        CB = ST._chunk_bytes(geom.depth, hard=False)
        runs = [CS.phase_times([item], kind, geom, CB) for _ in range(reps)]
        out[name] = {k: min(r["phases"][k]["ms"] for r in runs)
                     for k in runs[0]["phases"]}
        out[name]["e_ms"] = min(r["e_ms"] for r in runs)
    return out


if __name__ == "__main__":
    sys.exit(main())
