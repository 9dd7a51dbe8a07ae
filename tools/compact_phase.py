#!/usr/bin/env python3
"""An encode block's compaction-to-host phase on one GPU, measured the
same way on any tree of the PyTorch/CUDA port: from the join of the
block's Kernel E launches to its payloads on the host
(streams_torch.encode_block's overflow read-back, Kernel C, the copies to
the host, the flush bytes), and Kernel C's device time per block.

The pinned block (65,536 reads x 100 bp, bench.py's generator) is prepared
as the main path prepares it (pipeline_native.prepare_block_fast,
_coder_jobs). Kernel E runs once per stream and its outputs are kept;
encode_block then runs with E's wrapper (coder_torch.lane_encode_blocks,
or lane_encode on a tree from before the window path) answering from
them, keyed on the wrapper's arguments (each stream's inputs, the
symbols with pos/reset and counts or a tree's schedule, by address), so
the call costs the phase after the join and nothing of E. Each call is
timed with the host clock (it returns with the payloads on the host) and
with CUDA events on the calling stream, and must give the payloads of the
first, uncached call. Then, under torch.profiler, the mean device time
of Kernel C's launches (kernels whose name holds "compact") and of the
device-to-host copies, times their count per block (the wrappers' launch
counter for C: the profiler may drop a record), and the host time of
each trace span (`sfq.*`) per block.

Usage: python3 tools/compact_phase.py [--root TREE] [level ...]
(default level 3 and 4). --root: the checkout whose slimfastq_tpu_torch
is measured (default: this one), so that an earlier tree unpacked beside
it is measured by the same code. One JSON line per level.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

READS, READ_LEN = 65536, 100
REPS = 20


def _median_span(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _key(x):
    """A call's arguments as a cache key: tensors by address, and the
    tuples that hold them (a stream's EncIn) by their tensors."""
    if hasattr(x, "data_ptr"):
        return x.data_ptr()
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    return x if isinstance(x, int) else id(x)


def phase(data: bytes, level: int, dev, reps: int = REPS) -> dict:
    """The phase of the pinned block's encode at `level` on `dev` (ms)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda, coder_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(level)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    jobs = list(PN._coder_jobs(pre, cfg, dev))
    want = ST.encode_block(jobs, dev)
    wrapper = ("lane_encode_blocks" if hasattr(coder_torch,
                                               "lane_encode_blocks")
               else "lane_encode")
    real, cache = getattr(coder_torch, wrapper), {}

    def cached(*args):
        key = _key(args)
        if key not in cache:
            cache[key] = real(*args)
        return cache[key]

    setattr(coder_torch, wrapper, cached)
    try:
        ST.encode_block(jobs, dev)
        host, events = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            t0.record()
            got = ST.encode_block(jobs, dev)
            t1.record()
            host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            events.append(t0.elapsed_time(t1))
            for name, (pay, lens) in want.items():
                if not (np.array_equal(got[name][0], pay)
                        and np.array_equal(got[name][1], lens)):
                    raise AssertionError(f"L{level} {name}: the phase with "
                                         "E's outputs kept differs")
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ST.encode_block(jobs, dev)
            torch.cuda.synchronize()
        launches = _cuda.launches["compact_lanes_dev"] / reps
    finally:
        setattr(coder_torch, wrapper, real)
    c_ms = c_n = d2h_ms = d2h_n = 0
    spans = {}
    for e in prof.key_averages():
        if e.key.startswith("sfq.") and e.device_type != DeviceType.CUDA:
            spans[e.key] = e.cpu_time_total / 1e3 / reps
        if e.device_type != DeviceType.CUDA or e.key.startswith("sfq."):
            continue  # a trace span's device entry sums its kernels
        if "compact" in e.key:
            c_ms += e.self_device_time_total / 1e3
            c_n += e.count
        elif e.key.startswith("Memcpy DtoH"):
            d2h_ms += e.self_device_time_total / 1e3
            d2h_n += e.count
    return {"level": level, "streams": len(want),
            "host_ms": _median_span(host), "events_ms": _median_span(events),
            "compact_launches_per_block": launches,
            "compact_device_ms_per_block": c_ms / max(c_n, 1) * launches,
            "compact_records": c_n,
            "d2h_copies_per_block": d2h_n / reps,
            "d2h_device_ms_per_block": d2h_ms / reps,
            "span_host_ms_per_block": dict(sorted(spans.items()))}


def main(argv) -> int:
    root = HERE
    if argv[:1] == ["--root"]:
        root, argv = os.path.abspath(argv[1]), argv[2:]
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("compact_phase: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(READS, read_len=READ_LEN, seed=0, var_len=False,
                       n_rate=0.0005)
    card = torch.cuda.get_device_name(0)
    for level in [int(a) for a in argv] or [3, 4]:
        print(json.dumps({"compact_phase": {
            "root": os.path.relpath(root, HERE), "card": card,
            **phase(data, level, torch.device("cuda"))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
