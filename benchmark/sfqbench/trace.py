"""The device trace of a traced run: torch.profiler around each call of
the window, reduced as soon as the call ends (outside its wall) to

- the seconds each card was busy: the union of its device activities'
  intervals inside the call (a block's streams run at once on their
  own CUDA streams, so their times overlap and a sum would overcount);
- the device seconds of each kernel (and copy), by its name without
  template arguments, summed over its launches;
- the idle gaps inside the call, each put down to the stage the main
  thread was in at its middle (``stage.<name>`` marks, sfqbench.stages),
  summed by stage.

The union and the kernel names follow the port's tools/gpu_profile.py.
"""

from __future__ import annotations

import re
import time

_KERNEL = re.compile(r"([A-Za-z_][A-Za-z0-9_]*_kernel)")


def kernel_name(key: str) -> str:
    m = _KERNEL.search(key)
    return m.group(1) if m else key[:48]


def union(intervals) -> list:
    """Merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


# device activities that are work on the card (not annotation ranges)
_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
_MARKS = ("bench.", "stage.", "sfq.")


def _work(e) -> bool:
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA:
        return False
    try:
        return e.activity_type() in _WORK
    except AttributeError:  # a torch without activity types: by name
        return not (e.is_user_annotation() or e.name().startswith(_MARKS)
                    or e.name() == "Activity Buffer Request")


def reduce(events, kind: str) -> dict:
    """The call's trace from the profiler's raw events (kineto's, read
    without building torch's event tree, which takes seconds a call)."""
    from torch.autograd import DeviceType
    mark, dev, stages = None, {}, []
    for e in events:
        if _work(e):
            dev.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif (e.name() == "bench." + kind and e.is_user_annotation()
              and e.device_type() == DeviceType.CPU):
            mark = e  # the host's range (the card's copy spans its work)
    if mark is None:
        raise RuntimeError("the call's mark is missing from the trace")
    lo = mark.start_ns()
    hi = lo + mark.duration_ns()
    main = mark.start_thread_id()
    for e in events:
        if (e.is_user_annotation() and e.device_type() == DeviceType.CPU
                and e.start_thread_id() == main
                and e.name().startswith("stage.")):
            stages.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.name()[len("stage."):]))
    stages.sort()
    busy, kernels, gaps = {}, {}, {}
    for d, evs in dev.items():
        for a, b, name in evs:
            k = kernel_name(name)
            kernels[k] = kernels.get(k, 0.0) + (b - a) / 1e9
        merged = union((max(a, lo), min(b, hi)) for a, b, _ in evs
                       if b > lo and a < hi)
        busy[d] = sum(b - a for a, b in merged) / 1e9
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label = (a + b) / 2, "main"
            for s0, s1, name in stages:
                if s0 <= mid < s1:
                    label = name  # the innermost mark that holds it
            key = f"{kind}.{label}"
            gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e9 / len(dev)
    return {"busy_s": busy, "window_s": (hi - lo) / 1e9,
            "kernels": kernels, "gaps": gaps}


class Profiled:
    """The traced run's call runner: the profiler and the stage clock
    around the call, the reduction after it."""

    def __init__(self, stages, sync):
        self.stages, self.sync = stages, sync
        # the profiler's start, stop and reduction: kept out of the window
        self.overhead_s = 0.0

    def __call__(self, kind: str, call):
        def run(fn):
            import torch
            from torch.profiler import ProfilerActivity, profile
            t0 = time.perf_counter()
            self.stages.take()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("bench." + kind):
                    t = time.perf_counter()
                    out = fn()
                    self.sync()
                    wall = time.perf_counter() - t
            call.trace = reduce(prof.profiler.kineto_results.events(), kind)
            call.trace["stages"] = self.stages.take()
            self.overhead_s += time.perf_counter() - t0 - wall
            return out, wall
        return run
