"""What decides ``correct``: every output of the window against what it
must be, each number compared with its limit.

- ``decode_wrong``: decode calls whose FASTQ is not the file that was
  encoded, byte for byte (the codec is lossless), or that raised;
- ``encode_unstable``: encode calls whose container differs from the
  first container of the same file (the format is frozen, so one file
  has one container), or that raised;
- ``format_faults``: departures of that first container from the
  format, by the plain reference (reference/check.py): header, framing,
  CRCs, each block's head;
- ``lanes_wrong``: lanes of the sampled blocks whose coded bytes (QUAL,
  SEQ, LEN) are not the reference's.

The first two are counted as each call ends, outside its wall, and the
call's output is dropped then; the last two once the window has closed.
All four are exact: each limit is 0.
"""

from __future__ import annotations

import random
import time

from reference import check as refcheck

LIMITS = {"decode_wrong": 0, "encode_unstable": 0, "format_faults": 0,
          "lanes_wrong": 0}
# blocks whose coded bytes the reference compares, drawn from the seed
# over all blocks of the cell's files
SAMPLE_BLOCKS = 2
# symbol-steps of each sampled stream the reference codes: a 100 bp
# block's streams (6,400 steps) whole, with their flush and lengths; of
# a HiFi block's (132,000) the first 8,192, which at 1,024 lanes span 14
# of Kernel E's slices of QUAL (2^22 decisions each) and 4 of SEQ
STEPS = 8192


class Judge:
    """Called with each call of the window as it ends: holds the first
    container of each file and counts the outputs that are not what they
    must be. ``numbers()`` then runs the reference."""

    def __init__(self, files: list):
        self.files = files
        self.held: dict = {}
        self.decode_wrong = self.encode_unstable = 0

    def __call__(self, c) -> None:
        if c.kind == "encode":
            if c.error is not None:
                self.encode_unstable += 1
            elif c.file not in self.held:
                self.held[c.file] = c.out
            elif c.out != self.held[c.file]:
                self.encode_unstable += 1
        elif c.error is not None or c.out != self.files[c.file]:
            self.decode_wrong += 1

    def numbers(self, config: dict, seed: int, device="cpu") -> tuple:
        """({name: (value, limit)}, what the reference found)."""
        t = time.perf_counter()
        pick = random.Random(seed)
        found = {"faults": [], "lanes": 0}
        br = config["block_records"]
        pool = [(f, b) for f in sorted(self.held) for b in range(
            max(1, -(-self.files[f].count(b"\n") // 4 // br)))]
        sample = pick.sample(pool, min(SAMPLE_BLOCKS, len(pool)))
        lanes_wrong = 0
        for f, data in sorted(self.held.items()):
            res = refcheck.check(data, self.files[f], config,
                                 [b for g, b in sample if g == f], STEPS,
                                 device)
            found["faults"] += [f"file {f}: {x}" for x in res["faults"]]
            found["lanes"] += res["lanes"]
            lanes_wrong += res["lanes_off"]
        found["seconds"] = time.perf_counter() - t
        numbers = {"decode_wrong": self.decode_wrong,
                   "encode_unstable": self.encode_unstable,
                   "format_faults": len(found["faults"]),
                   "lanes_wrong": lanes_wrong}
        return {k: (v, LIMITS[k]) for k, v in numbers.items()}, found
