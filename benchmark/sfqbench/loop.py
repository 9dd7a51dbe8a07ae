"""The closed loop of one client: encode a file, decode its container,
then the next file, until the first call that ends past the window's
length. Every completed call counts with its whole wall. Each call's
output is handed to ``after`` as the call ends and dropped once its
decode has run, so the window holds no more than one file's outputs."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field


@dataclass
class Call:
    kind: str          # "encode" or "decode"
    file: int          # which of the cell's files
    raw_bytes: int     # FASTQ bytes coded or restored
    wall_s: float
    out: object = None           # what the call returned
    error: str | None = None     # what it raised
    trace: dict = field(default_factory=dict)


def closed_loop(files: list, encode, decode, seconds: float,
                around=None, sync=None, after=None) -> list:
    """Run the window. ``around(kind, call)`` may give each call a
    runner of its own (the traced run's profiler and stage clock: their
    own work falls outside the call's wall, and the time it reports in
    ``overhead_s`` outside the window's); ``sync()`` waits for the device
    before each call starts; ``after(call)`` checks each call's output
    as it ends, outside its wall and the window's. Returns the calls in
    order, their outputs dropped."""
    calls: list = []
    start = time.perf_counter()
    checking = [0.0]

    def call(kind: str, fn, arg, f: int) -> Call:
        c = Call(kind, f, len(files[f]), 0.0)
        run = around(kind, c) if around else _plain
        if sync:
            sync()
        try:
            c.out, c.wall_s = run(lambda: fn(arg))
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            c.error, c.wall_s = f"{type(e).__name__}: {e}", float("nan")
        calls.append(c)
        if after:
            t = time.perf_counter()
            after(c)
            checking[0] += time.perf_counter() - t
        return c

    def over() -> bool:
        return time.perf_counter() - start - checking[0] - getattr(
            around, "overhead_s", 0.0) >= seconds

    for i in itertools.count():
        f = i % len(files)
        enc = call("encode", encode, files[f], f)
        if enc.error is None and not over():
            dec = call("decode", decode, enc.out, f)
            dec.out = None
        enc.out = None
        if over():
            return calls


def _plain(fn) -> tuple:
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def rate_GBps(calls: list, kind: str) -> float | None:
    """Raw GB (10^9 B) of the completed calls of ``kind`` over their
    summed walls."""
    done = [c for c in calls if c.kind == kind and c.error is None]
    wall = sum(c.wall_s for c in done)
    if not done or wall <= 0:
        return None
    return sum(c.raw_bytes for c in done) / wall / 1e9
