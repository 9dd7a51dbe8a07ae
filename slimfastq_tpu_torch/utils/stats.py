"""Observability of the port: per-stream size reports (``sfq -v``; the
reference prints per-stream compressed sizes with a verbose flag, here a
structured dict usable by the CLI and tests) and the program's spans.

A span (``trace``) marks a stage of the pipelines by name. While no
``recording()`` context is open and no torch profiler is active a span
costs one flag test and does nothing else. While one is, each span is
kept in an in-memory log (``spans()`` hands it back), and is also entered
as a ``torch.profiler.record_function`` of its name and, once CUDA is up,
an NVTX range, so a device trace shows the same names. A logged span
holds its name, its thread, its start and end, the enclosing span on its
thread, the api call it belongs to (``root`` opens a call; a pool's work
takes the id its submitter had, ``current_call``) and integer attributes.
Start and end are Unix nanoseconds on the clock the profiler stamps its
CPU events with: ``time.perf_counter_ns()`` plus an offset to
``time.time_ns()`` taken when recording starts and at each call's root,
so the idle gaps of a device trace can be put down to the innermost
span."""

from __future__ import annotations

import io
import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# the most spans the log holds; past it, spans are counted as dropped
CAP = 1 << 20


def container_report(encoded: bytes) -> dict:
    """Per-stream compressed byte totals + container overhead for one
    encoded container."""
    from .. import container
    f = io.BytesIO(encoded)
    cfg = container.read_header(f)
    totals: dict[str, int] = {}
    nrec = 0
    nblocks = 0
    for blk in container.iter_blocks(f, cfg):
        nrec += blk.num_records
        nblocks += 1
        for name, es in blk.streams.items():
            totals[name] = totals.get(name, 0) + int(es.lane_lens.sum())
    payload = sum(totals.values())
    return {
        "records": nrec,
        "blocks": nblocks,
        "compressed_bytes": len(encoded),
        "stream_bytes": totals,
        "header_overhead_bytes": len(encoded) - payload,
    }


class Span(NamedTuple):
    """One logged span: ``parent`` is the id of the enclosing span on its
    thread (None at the top), ``call`` the id of the api call it belongs
    to (None outside one)."""
    name: str
    id: int
    parent: int | None
    call: int | None
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class Log(NamedTuple):
    """What ``spans()`` hands back: the spans in the order they ended, and
    how many were dropped past CAP."""
    spans: list
    dropped: int


_recording = 0  # open recording() contexts
_lock = threading.Lock()
_log: list = []
_dropped = 0
_ids = itertools.count(1)
_calls = itertools.count(1)
_offset = time.time_ns() - time.perf_counter_ns()
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _resync() -> None:
    global _offset
    _offset = time.time_ns() - time.perf_counter_ns()


class _Off:
    """The span while nothing records: enters and leaves, keeps nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "call", "attrs", "id", "parent", "off", "start",
                 "rf", "nvtx", "thread")

    def __init__(self, name: str, call, attrs: dict):
        self.name, self.call, self.attrs = name, call, attrs

    def set(self, **attrs) -> None:
        """Set integer attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.call is None and top is not None:
            self.call = top.call
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.off = _offset
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        try:
            self.rf.__exit__(*exc)
        finally:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            _stack().pop()
            _keep(Span(self.name, self.id, self.parent, self.call,
                       self.thread, self.start + self.off, end + self.off,
                       self.attrs))
        return False


def _keep(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_log) < CAP:
            _log.append(span)
        else:
            _dropped += 1


def trace(name: str, call: int | None = None, **attrs):
    """A span of ``name`` (a context manager; the body's exceptions
    propagate). ``call``: the api call's id where the span opens on a
    thread that has none (a pool's work); else the enclosing span's.
    ``attrs``: integer attributes (more through ``set`` on the entered
    span)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _On(name, call, attrs)


def root(name: str, **attrs):
    """The span of one api call: ``trace`` with a new call id."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    _resync()
    return _On(name, next(_calls), attrs)


def current_call() -> int | None:
    """The call id of the calling thread's innermost open span (None
    outside one): what work submitted to a pool is handed."""
    stack = getattr(_local, "stack", None)
    return stack[-1].call if stack else None


@contextmanager
def recording():
    """Keep spans in the log while entered (nested contexts add up)."""
    global _recording
    with _lock:
        if not _recording:
            _resync()
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> Log:
    """The logged spans, in the order they ended, and the count dropped
    past CAP; the log is emptied."""
    global _log, _dropped
    with _lock:
        out = Log(_log, _dropped)
        _log, _dropped = [], 0
    return out
