#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port (slimfastq_tpu_torch) on
one GPU: the pinned block (65,536 reads x 100 bp, level 3 or 4, the
generator of bench.py and chip_smoke.py) encoded and decoded once, warm,
under torch.profiler.

Prints one JSON line per direction: its wall seconds; device time by
kernel (self device time summed over launches, and the launch count,
copies included); the device busy share of the wall (the union of the
device activities' intervals over the wall: a block's coder streams run
at once on their own CUDA streams, so their times overlap) beside the sum
of all device time; the peak device memory (torch's allocator);
Kernel C's device time and launches per block
(encode), beside the rows of the coder kernels and of Kernels L (lane
layout) and U (unpack); and, for the codec's trace
spans (`sfq.*`), the host time and the device time of the work they
enqueued, each summed over the span's calls.
With --block-records (and --window) the same for smaller blocks coded
in windows, e.g. the 16k window: 65,536 reads as 4 blocks of 16,384 in
one window of 4 (Kernel C per block is then the window's launch divided
by its blocks). With --read-len the reads' length, e.g. 16500 for the
long-read block (65,536 reads, raw span past 2 GiB: the host-pack path).
Needs a CUDA card.

Usage: python3 tools/gpu_profile.py [reads [level]] [--block-records N]
       [--window B] [--read-len L]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _kernel_name(key: str) -> str:
    m = re.search(r"(lane_decode_kernel<[^>]*>|lane_decode_kernel|"
                  r"compact_streams_kernel|compact_lanes_kernel|"
                  r"lane_layout_kernel|lane_unpack_kernel|"
                  r"touch_kernel<[^>]*>|entry_scan_kernel<[^>]*>|"
                  r"rows_kernel|radix_hist_kernel|radix_scatter_kernel|"
                  r"scan_reduce_kernel|scan_apply_kernel|gather_kernel|"
                  r"lane_code_kernel)", key)
    return m.group(1) if m else key[:80]


def _union_s(intervals) -> float:
    """Seconds covered by a set of (start, end) intervals in us."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def _profile(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device, spans = {}, {}
    for e in prof.key_averages():
        on_device = e.device_type == DeviceType.CUDA
        if e.key.startswith("sfq."):
            # a span has a host entry and, where it enqueued device work,
            # a device entry of the same name
            s = spans.setdefault(e.key, {"host_ms": 0.0, "device_ms": 0.0,
                                         "count": 0})
            if on_device:
                s["device_ms"] += e.device_time_total / 1e3
            else:
                s["host_ms"] += e.cpu_time_total / 1e3
                s["count"] += e.count
        elif on_device and e.key != "Activity Buffer Request":
            name = _kernel_name(e.key)
            d = device.setdefault(name, {"device_ms": 0.0, "count": 0})
            d["device_ms"] += e.self_device_time_total / 1e3
            d["count"] += e.count
    busy = _union_s((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.name != "Activity Buffer Request")
    total = sum(d["device_ms"] for d in device.values()) / 1e3
    return out, {"wall_s": wall, "device_busy_s": busy,
                 "device_busy_share": busy / wall,
                 "device_sum_s": total,
                 "device": dict(sorted(device.items(),
                                       key=lambda kv: -kv[1]["device_ms"])),
                 "spans": dict(sorted(spans.items()))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gpu_profile: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    p = argparse.ArgumentParser()
    p.add_argument("reads", type=int, nargs="?", default=65536)
    p.add_argument("level", type=int, nargs="?", default=3)
    p.add_argument("--block-records", type=int, default=None)
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--read-len", type=int, default=100)
    args = p.parse_args()
    reads, level = args.reads, args.level
    kw = {"level": level, "window": args.window}
    if args.block_records:
        kw["block_records"] = args.block_records
    data = synth_fastq(reads, read_len=args.read_len, seed=0,
                       var_len=False, n_rate=0.0005)
    enc = api.encode_fastq(data, **kw)       # warm: build, allocate
    assert api.decode_fastq(enc, window=args.window) == data
    torch.cuda.reset_peak_memory_stats()
    enc, rep_e = _profile(lambda: api.encode_fastq(data, **kw))
    rep_e["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    dec, rep_d = _profile(lambda: api.decode_fastq(enc, window=args.window))
    rep_d["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    assert dec == data
    card = torch.cuda.get_device_name(0)
    block_records = args.block_records or config_for_level(
        level).block_records
    blocks = -(-reads // block_records)
    c = [d for k, d in rep_e["device"].items() if k.startswith("compact_")]
    rep_e["kernel_c"] = {
        "device_ms_per_block": sum(d["device_ms"] for d in c) / blocks,
        "launches_per_block": sum(d["count"] for d in c) / blocks}
    for direction, rep in (("encode", rep_e), ("decode", rep_d)):
        extra = ({} if args.block_records is None and args.window is None
                 else {"block_records": block_records,
                       "window": args.window})
        if args.read_len != 100:
            extra["read_len"] = args.read_len
        print(json.dumps({"direction": direction, "reads": reads,
                          "level": level, **extra,
                          "raw_bytes": len(data),
                          "compressed_bytes": len(enc), "card": card,
                          **rep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
