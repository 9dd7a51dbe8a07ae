#!/usr/bin/env python3
"""Walls of the sharded path on every card of the node (PyTorch/CUDA
port): chip_smoke.py's `sharded` phase alone. The pinned block keeps its
SHA-256 pins through parallel.sharded on make_mesh() (every card) and on
a mesh naming cuda:0 twice; the 4 x 64k set at level 3 and 4 gives
api.encode_fastq's container, and its encode and decode walls on one
card, on the mesh and on the card twice are taken in turns (single,
mesh, twice, twice, mesh, single; after one untimed pass on each mesh)
with each shard's launches. On a node
with several cards this measures sharding across distinct cards. Prints
the card names and power limits, then chip_smoke's `sharded` JSON line.
Needs a CUDA card.

Usage: python3 tools/sharded_walls.py
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sharded_walls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from slimfastq_tpu_torch.ops import _cuda
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()
    chip_smoke.sharded(chip_smoke._pinned(chip_smoke.READS),
                       chip_smoke._pinned(chip_smoke.READS
                                          * chip_smoke.WALL_BLOCKS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
