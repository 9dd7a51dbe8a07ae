"""Structured observability: per-stream size reports and throughput
counters (SURVEY.md §5 "Metrics / logging": the reference prints per-stream
compressed sizes with a verbose flag; here it's a structured dict usable by
the CLI, tests and dashboards)."""

from __future__ import annotations

import io
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


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


@dataclass
class Counters:
    """Throughput/byte counters for an encode or decode run."""
    raw_bytes: int = 0
    coded_bytes: int = 0
    stage_seconds: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                        + time.perf_counter() - t0)

    def report(self) -> dict:
        total = sum(self.stage_seconds.values())
        return {
            "raw_bytes": self.raw_bytes,
            "coded_bytes": self.coded_bytes,
            "ratio": (self.raw_bytes / self.coded_bytes
                      if self.coded_bytes else None),
            "seconds": round(total, 4),
            "mb_per_s": (round(self.raw_bytes / total / 1e6, 2)
                         if total else None),
            "stages": {k: round(v, 4)
                       for k, v in sorted(self.stage_seconds.items())},
        }


@contextmanager
def trace(name: str):
    """torch.profiler annotation (near free when profiling is off) so
    device traces show codec stages; once CUDA is initialised, also an
    NVTX range of the same name, for a CUDA timeline tool. The body's
    exceptions propagate."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
