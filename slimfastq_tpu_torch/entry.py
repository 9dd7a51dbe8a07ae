"""Entry points of the port: the flagship step and a multi-card dry
run (the JAX package's __graft_entry__.py, on PyTorch and the port's
kernels).

``entry()`` returns the flagship step, the lane-interleaved adaptive range
coder's encode of one quality stream at level-3 geometry: Kernel E
(ops/coder_torch.lane_encode) on the stream's symbols, pos, reset and
counts, with example inputs on the device.
``dryrun_multichip(n)`` runs three bit-exact sharded round trips over a
mesh of n devices: a toy level-2 run, level 3 at production geometry
(W = 1024 / 64) and level 4 with the long-range matcher engaged.

Both run on the card unless the caller names the CPU (``device="cpu"``,
``devices=["cpu"] * n``); without a card they raise.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from . import api, container
from .config import config_for_level
from .ops import coder_torch, streams_torch
from .parallel.mesh import make_mesh
from .parallel.sharded import decode_fastq_sharded, encode_fastq_sharded
from .pipeline import MATCH_USED
from .utils.synth import corpus, synth_fastq


def entry(device=None):
    """(fn, example_args) of the flagship step: S = 256 steps of W = 128
    lanes of quality symbols from np.random.default_rng(0), the reads 100
    steps long, on the device; fn(*example_args) is Kernel E's (ebufs
    [NC, W, CB] u8, eptrs [NC, W] int32, low [W], emax) (the plain
    version on the CPU)."""
    dev = api.resolve_device(device)
    S, W = 256, 128
    geom = config_for_level(3).qual
    CB = streams_torch._chunk_bytes(geom.depth, hard=False)
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 40, size=(S, W)).astype(np.uint8)
    counts = np.full(W, S, dtype=np.int32)
    pos = np.tile((np.arange(S, dtype=np.int32) % 100)[:, None], (1, W))
    reset = (pos == 0).astype(np.int32)

    def fn(syms, pos, reset, counts):
        return coder_torch.lane_encode(syms, pos, reset, counts, "qual", geom,
                                       CB)

    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (syms, pos, reset, counts))
    return fn, args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Encode and decode three inputs over a mesh of ``n_devices`` cards
    (or over ``devices``, e.g. ["cpu"] * n) through
    parallel.sharded.encode_fastq_sharded, each container held to give its
    input back through api.decode_fastq on the mesh's first device and
    through decode_fastq_sharded:

    - toy: level 2, 16 / 8 lanes, 32-record blocks, 32n + 12 records (one
      block a shard and a ragged one);
    - production: level 3 at W = 1024 / 64 lanes, 2,048-record blocks,
      2 * 2048n + 500 records (2n + 1 blocks);
    - match: level 4, 64 / 16 lanes, 1,536-record blocks of a coverage
      corpus, with MATCH_USED on at least one block.

    Prints one line a phase; returns {phase: container}."""
    mesh = make_mesh(n_devices, devices)
    if mesh.size < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {mesh.size}")
    first = mesh.devices[0]
    n = n_devices
    phases = (
        ("toy", config_for_level(2, lanes=16, aux_lanes=8, block_records=32),
         32 * n + 12, lambda r: synth_fastq(r, read_len=20, seed=0,
                                            var_len=True, n_rate=0.01)),
        ("production", config_for_level(3, block_records=2048),
         2048 * 2 * n + 500, lambda r: synth_fastq(r, read_len=25, seed=1,
                                                   var_len=True,
                                                   n_rate=0.002)),
        ("match", config_for_level(4, lanes=64, aux_lanes=16,
                                   block_records=1536),
         1536 * max(2, n // 2), lambda r: corpus("novaseq", r, seed=3)),
    )
    out = {}
    for name, cfg, records, make in phases:
        data = make(records)
        enc = encode_fastq_sharded(data, cfg, mesh)
        if api.decode_fastq(enc, device=first) != data:
            raise AssertionError(f"{name}: the sharded container did not "
                                 "round-trip")
        if decode_fastq_sharded(enc, mesh) != data:
            raise AssertionError(f"{name}: the sharded decode did not "
                                 "round-trip")
        what = f"{records} records, {-(-records // cfg.block_records)} blocks"
        if name == "match":
            f = io.BytesIO(enc)
            hdr = container.read_header(f)
            used = [bool(b.flags & MATCH_USED)
                    for b in container.iter_blocks(f, hdr)]
            if not any(used):
                raise AssertionError("match: the MATCH stream did not engage "
                                     "on coverage data")
            what += f", {sum(used)} with MATCH"
        print(f"dryrun_multichip({n}): {name} (L{cfg.level}, W = "
              f"{cfg.lanes}/{cfg.aux_lanes}, {what}) round-trips bit-exactly "
              f"over {mesh.size} shards ({len(data)} -> {len(enc)} bytes)",
              flush=True)
        out[name] = enc
    return out
