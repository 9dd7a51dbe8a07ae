"""The program's own spans (slimfastq_tpu_torch.utils.stats), as the
metric files read them. A traced run's profiler turns the port's spans
on, so its log holds every span of the window's calls and of no other
(no warm-up call is profiled). The log is taken once, by the first
reader after the window, and kept for the run's other readers. A program
that keeps no log gives every reader None.

A call is the spans that share a call id; its root, ``sfq.encode`` or
``sfq.decode``, holds the raw bytes it coded and runs on the call's main
thread. Main-thread metrics are self time (a span's wall less what its
child spans cover); a pool's spans are summed over its threads. Times
are per raw GB (10^9 B) of the calls of that direction."""

from __future__ import annotations

from fnmatch import fnmatchcase

_TAKEN: dict = {}


def _take():
    try:
        from slimfastq_tpu_torch.utils import stats
        return stats.spans().spans
    except (ImportError, AttributeError):
        return None


def of(run) -> "Spans | None":
    """The spans of ``run``'s traced window, None where the program keeps
    none."""
    if _TAKEN.get("run") is not run:
        got = _take()
        _TAKEN.update(run=run, spans=Spans(got) if got else None)
    return _TAKEN["spans"]


class Spans:
    def __init__(self, spans: list):
        self.spans = spans
        self.roots = {s.call: s for s in spans if s.parent is None
                      and s.name in ("sfq.encode", "sfq.decode")}
        self.cover: dict = {}
        for s in spans:
            if s.parent is not None:
                self.cover[s.parent] = (self.cover.get(s.parent, 0)
                                        + s.end_ns - s.start_ns)

    def _calls(self, kind: str) -> dict:
        return {c: r for c, r in self.roots.items()
                if r.name == "sfq." + kind}

    def _of(self, kind: str, patterns, main: bool) -> list:
        calls = self._calls(kind)
        return [s for s in self.spans if s.call in calls
                and (not main or s.thread == calls[s.call].thread)
                and any(fnmatchcase(s.name, p) for p in patterns)]

    def self_ns(self, s) -> int:
        return s.end_ns - s.start_ns - self.cover.get(s.id, 0)

    def raw_GB(self, kind: str) -> float:
        return sum(r.attrs.get("raw_bytes", 0)
                   for r in self._calls(kind).values()) / 1e9

    def _per_GB(self, kind: str, ns: int) -> float | None:
        gb = self.raw_GB(kind)
        return 1e-6 * ns / gb if gb > 0 else None

    def self_ms_per_GB(self, kind: str, patterns) -> float | None:
        """Self time of the main thread's spans whose names match
        ``patterns`` (fnmatch), ms per raw GB."""
        return self._per_GB(kind, sum(
            self.self_ns(s) for s in self._of(kind, patterns, True)))

    def pool_ms_per_GB(self, kind: str, name: str) -> float | None:
        """Wall of the spans of ``name`` summed over every thread, ms per
        raw GB."""
        return self._per_GB(kind, sum(
            s.end_ns - s.start_ns for s in self._of(kind, (name,), False)))

    def unspanned_pct(self, kind: str) -> float | None:
        """Percent of the roots' wall in no span of the main thread but
        the root and the device steps (``sfq.<kind>.step``)."""
        wall = sum(r.end_ns - r.start_ns
                   for r in self._calls(kind).values())
        if wall <= 0:
            return None
        bare = sum(self.self_ns(s) for s in self._of(
            kind, ("sfq." + kind, f"sfq.{kind}.step"), True))
        return 100.0 * bare / wall

    def per_block(self, kind: str, name: str) -> float | None:
        """Spans of ``name`` per block the device steps took."""
        blocks = sum(s.attrs.get("blocks", 0) for s in self._of(
            kind, (f"sfq.{kind}.step",), True))
        if blocks <= 0:
            return None
        return len(self._of(kind, (name,), False)) / blocks
