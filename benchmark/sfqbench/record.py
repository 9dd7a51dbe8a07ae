"""What a run hands to the metric readers (``metrics/<name>.py``, each a
``read(run)`` that returns a number or None where it finds nothing to
read)."""

from __future__ import annotations


class Run:
    def __init__(self, calls, setup_s, device_name, chips, shapes=None):
        self.calls = calls
        self.setup_s = setup_s
        self.device_name = device_name
        self.chips = chips
        self.shapes = shapes or {}  # file -> roofline.block_shapes

    def done(self, kind: str) -> list:
        return [c for c in self.calls if c.kind == kind and c.error is None]

    def traced(self, kind: str) -> list:
        return [c for c in self.done(kind) if c.trace]

    def raw_GB(self, kind: str, traced: bool = False) -> float:
        calls = self.traced(kind) if traced else self.done(kind)
        return sum(c.raw_bytes for c in calls) / 1e9

    def stage_ms_per_GB(self, kind: str, names) -> float | None:
        """Host milliseconds of the stages ``names`` summed over the
        traced ``kind`` calls, per raw GB they coded; None where none
        of the stages ran."""
        calls = self.traced(kind)
        got = [c.trace["stages"][n] for c in calls for n in names
               if n in c.trace["stages"]]
        gb = self.raw_GB(kind, traced=True)
        if not got or gb <= 0:
            return None
        return 1e3 * sum(got) / gb

    def idle_pct(self, kind: str) -> float | None:
        """100 x (1 - busy / wall) over the traced ``kind`` calls, the
        busy seconds averaged over the cards."""
        calls = self.traced(kind)
        wall = sum(c.trace["window_s"] for c in calls)
        if not calls or wall <= 0 or self.device_name == "cpu":
            return None
        busy = sum(sum(c.trace["busy_s"].values()) for c in calls) \
            / max(self.chips, 1)
        return 100.0 * (1.0 - busy / wall)
