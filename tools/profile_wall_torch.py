#!/usr/bin/env python3
"""Host-stage wall profile of the PyTorch/CUDA port's block pipeline
(slimfastq_tpu_torch.api) on the card, with the real kernels.

Each stage function is wrapped by module attribute (the JAX package's
tools/profile_wall.py does the same) and timed on the host clock, on
whatever thread calls it:

- prep: pipeline_native.prepare_block_fast (the prep pool);
- device_step: api.Card.encode / decode (the main thread: issuing the
  uploads and launches, the syncs below, the flush);
- within it, the host's waits on the card: sync_heads
  (streams_torch._heads: Kernel E's overflow check), sync_to_host
  (streams_torch._to_host: Kernel C's payloads brought back),
  sync_symbols (streams_torch.StreamSet.symbols: a stream's Kernel D
  symbols brought back), and seq_qual_decode
  (streams_torch.decode_seq_qual_raw_blocks, its launches and downloads);
- within those, the host's time in Kernel L's and U's wrappers (inputs
  staged and uploaded, outputs allocated, the launch): lane_layout,
  step_inputs, unpack_pair (pack_torch; on any thread);
- write_block / read_block (container), finish
  (pipeline_native.decode_block_finish, the finish pool);
- native: fastq_index, flush_append, fastq_assemble and the match_*
  calls.

On top of those, the main thread's waits on the pools' futures:
wait_prep (a prepared block), wait_write (the writer), wait_read (the
reader), wait_finish (a finished block). Each cell codes its set once to
warm up, then N times a direction; the line gives, per window, the
minimum over the N runs of each stage's seconds, and the walls' minimum
and median. The cells are PERF.md §5's: 4 x 64k blocks at L3 and at L4,
and 4 x 16k blocks (one window of 4) at L3; each swept over
SFQ_PIPE_DEPTH in {1, 2, 4} and SFQ_BATCH_BLOCKS in {1, 4}, which the
port reads as the JAX package does.

Usage: python3 tools/profile_wall_torch.py [--runs N] [--device cpu]
       [--cells 64k_l3,64k_l4] [--configs 2x4,1x1] [--ways decode]
(--configs: depth x window pairs; cells and configs default to the whole
sweep, --ways to both directions).
Prints one JSON line a cell, depth and window, then the card's name and
power limit. Runs on the card unless --device cpu is given (the plain
kernels: only for tiny inputs); without a card it exits 1.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pc = time.perf_counter

# (cell, level, block_records, reads): PERF.md §5's cells, the pinned
# generator's reads (65,536 a 64k block)
CELLS = (("64k_l3", 3, 65536, 262144), ("64k_l4", 4, 65536, 262144),
         ("16k_l3", 3, 16384, 65536))
DEPTHS, WINDOWS = (1, 2, 4), (1, 4)
# the function a pool runs -> the name of the main thread's wait on it
_WAITS = {"prepare_block_fast": "wait_prep", "<lambda>": "wait_write",
          "append": "wait_write", "next": "wait_read",
          "decode_block_finish": "wait_finish"}


class Profile:
    """While entered: the stage functions wrapped, and api's pools
    handing out futures whose result() the main thread's waits are timed
    on. ``take()`` returns {stage: seconds} since the last take."""

    def __init__(self):
        from slimfastq_tpu_torch import api, container, native
        from slimfastq_tpu_torch.ops import pack_torch as PT
        from slimfastq_tpu_torch.ops import streams_torch as ST
        self.targets = [
            (api, "prepare_block_fast", "prep"),
            (api.Card, "encode", "device_step"),
            (api.Card, "decode", "device_step"),
            (ST, "_heads", "sync_heads"),
            (ST, "_to_host", "sync_to_host"),
            (ST.StreamSet, "symbols", "sync_symbols"),
            (ST, "decode_seq_qual_raw_blocks", "seq_qual_decode"),
            (container, "write_block", "write_block"),
            (container, "read_block", "read_block"),
            (api, "decode_block_finish", "finish"),
            *((PT, name, name) for name in (
                "lane_layout", "step_inputs", "unpack_pair")),
            *((native, name, name) for name in (
                "fastq_index", "flush_append", "fastq_assemble",
                "match_find_arrays", "match_apply_arrays",
                "match_encode_lanes", "match_mflag", "match_parse",
                "match_reconstruct_arrays"))]
        self.api = api
        self.acc: dict = {}
        self.lock = threading.Lock()
        self.saved: list = []

    def add(self, name: str, dt: float) -> None:
        with self.lock:
            self.acc[name] = self.acc.get(name, 0.0) + dt

    def take(self) -> dict:
        with self.lock:
            out, self.acc = self.acc, {}
        return out

    def _wrap(self, real, name: str):
        @functools.wraps(real)
        def timed(*a, **k):
            t = pc()
            try:
                return real(*a, **k)
            finally:
                self.add(name, pc() - t)
        return timed

    def __enter__(self):
        for owner, attr, name in self.targets:
            real = owner.__dict__[attr]
            self.saved.append((owner, attr, real))
            setattr(owner, attr, self._wrap(real, name))
        prof = self

        class Pool(ThreadPoolExecutor):
            def submit(self, fn, *a, **k):
                fut = super().submit(fn, *a, **k)
                wait = _WAITS.get(getattr(fn, "__name__", ""), "wait_other")
                real = fut.result

                def result(timeout=None):
                    t = pc()
                    try:
                        return real(timeout)
                    finally:
                        prof.add(wait, pc() - t)
                fut.result = result
                return fut
        self.saved.append((self.api, "ThreadPoolExecutor",
                           self.api.ThreadPoolExecutor))
        self.api.ThreadPoolExecutor = Pool
        return self

    def __exit__(self, *exc):
        while self.saved:
            owner, attr, real = self.saved.pop()
            setattr(owner, attr, real)
        return False


@contextmanager
def pipeline_env(depth=None, window=None):
    """SFQ_PIPE_DEPTH and SFQ_BATCH_BLOCKS set while inside (None:
    unset), restored on the way out."""
    want = {"SFQ_PIPE_DEPTH": depth, "SFQ_BATCH_BLOCKS": window}
    old = {k: os.environ.get(k) for k in want}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
    put(want)
    try:
        yield
    finally:
        put(old)


# the stages that run on the main thread, by direction: with the rest of
# the main thread's time they make up the wall
MAIN = {"encode": ("fastq_index", "wait_prep", "device_step", "wait_write"),
        "decode": ("wait_read", "device_step", "wait_finish")}


def profile_cell(data: bytes, cfg, device, runs: int, depth=None,
                 window=None, ways=("encode", "decode")) -> tuple:
    """``data`` coded once to warm up, then ``runs`` times each way of
    ``ways`` under Profile, with SFQ_PIPE_DEPTH = depth and
    SFQ_BATCH_BLOCKS = window (None: unset). Each run's container and
    output are held to the warm run's. Returns (the container, the
    report)."""
    import torch
    from slimfastq_tpu_torch import api, native
    dev = api.resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    blocks = max(1, -(-native.fastq_index(data)[1] // cfg.block_records))
    rep = {"depth": depth, "window": window}
    with pipeline_env(depth, window):
        wb = api._batch_window(cfg)
        rep.update(windows=-(-blocks // wb), blocks=blocks,
                   pipe_depth=api._pipe_depth(), window_blocks=wb)
        enc = api.encode_fastq(data, cfg, device=device)
        if api.decode_fastq(enc, device=device) != data:
            raise AssertionError("the round trip is not exact")
        walls = {way: [] for way in ways}
        stages = {way: [] for way in ways}
        with Profile() as prof:
            for _ in range(runs):
                for way in ways:
                    sync()
                    prof.take()
                    t = pc()
                    if way == "encode":
                        out = api.encode_fastq(data, cfg, device=device)
                    else:
                        out = api.decode_fastq(enc, device=device)
                    sync()
                    wall = pc() - t
                    got = prof.take()
                    got["main_rest"] = wall - sum(got.get(k, 0.0)
                                                  for k in MAIN[way])
                    walls[way].append(wall)
                    stages[way].append(got)
                    if out != (enc if way == "encode" else data):
                        raise AssertionError(f"{way} under the profile "
                                             "differs from the warm run")
    for way in ways:
        names = sorted({k for got in stages[way] for k in got})
        rep[way] = {
            "wall_s_min": min(walls[way]),
            "wall_s_median": statistics.median(walls[way]),
            "walls_s": walls[way],
            "per_window_min_s": {
                k: min(got.get(k, 0.0) for got in stages[way])
                / rep["windows"] for k in names}}
    return enc, rep


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default=None)
    p.add_argument("--cells", default=",".join(c[0] for c in CELLS))
    p.add_argument("--configs", default=",".join(
        f"{d}x{w}" for d in DEPTHS for w in WINDOWS))
    p.add_argument("--ways", default="encode,decode")
    args = p.parse_args()
    cells = args.cells.split(",")
    configs = [tuple(int(x) for x in c.split("x"))
               for c in args.configs.split(",")]
    import torch
    if args.device is None and not torch.cuda.is_available():
        print("profile_wall_torch: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    card = None
    if args.device is None:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    data = {}
    for cell, level, block_records, reads in CELLS:
        if cell not in cells:
            continue
        if reads not in data:
            data[reads] = synth_fastq(reads, read_len=100, seed=0,
                                      var_len=False, n_rate=0.0005)
        cfg = config_for_level(level, block_records=block_records)
        for depth, window in configs:
            _, rep = profile_cell(data[reads], cfg, args.device, args.runs,
                                  depth, window, tuple(args.ways.split(",")))
            print(json.dumps({"profile_wall": {
                "cell": cell, "level": level,
                "block_records": block_records, "reads": reads,
                "runs": args.runs, "card": card, **rep}}), flush=True)
    print(card or "cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
