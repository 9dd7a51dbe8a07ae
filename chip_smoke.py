#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (slimfastq_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. kernels: each of Kernel E (lane_encode), D (lane_decode) and C
     (compact_lanes_dev, one stream) against its plain PyTorch version on
     the card, byte for byte, at W = 1024, Sp = 256 with the level-3 SEQ
     (all lanes at context 0 at every read start: the collision case,
     with 1,024 and with 700 active lanes, where the format's count field
     wraps) and QUAL geometries, at the aux width W = 64 with the byte and
     flag kinds (tables in shared memory), and with level 4's SEQ (order
     11, the match-context family: 1,024 and 700 flagged lanes on one
     entry) and QUAL (the q1-q2 delta); Kernel C's one launch over a
     ragged mix of streams (W of 8 to 1,024, counts above CB, an empty
     stream, rows longer than one shared-memory stage); then E and D
     timed with CUDA events on the main path's own inputs (the pinned 64k
     x 100 bp block's QUAL stream: W = 1024, Sp = 6400, NC = 800; and its
     level-4 SEQ stream as the winning match trial codes it), where D's
     output is held against the packed symbols, with the host's time for
     the level-4 matcher and trials; Kernel C's one launch over the pinned
     block's coded streams (7 at level 3, 11 at level 4, as encode_block
     hands them over; again with QUAL at the hard chunk size) against its
     plain version, its device time (profiler kernel records) and its
     wrapper-inclusive time (CUDA events) beside its byte bound and its
     32-byte-sector bound, at level 3 also on QUAL alone; the block's
     compaction-to-host phase (tools/compact_phase.py: from the join of
     the coder launches to the payloads on the host); and one 1,024-thread
     barrier timed, for D's lockstep bound (bit-steps x one barrier; E's
     is printed beside its byte bound);
  4. main path, level 3 then level 4: the pinned block through
     api.encode_fastq / decode_fastq on the card: container size and
     SHA-256 equal the JAX package's, the round trip is exact, every
     kernel's launch count moved (at level 4 the block takes a match
     trial); at level 3 the block's seven E and seven D launches, on the
     main path's inputs, timed alone and launched at once through the main
     path's StreamSet (the block's coder span, first launch to join,
     beside the sum); at level 4 its E launches (with the trials' SEQ and
     MATCH) alone and in two orders; the main path's device halves timed
     with CUDA events; then encode and decode wall time over 4 blocks of
     the same generator, at each level.

  5. the small-block window path on the same 4-block set at
     block_records = 16,384 (the 4 blocks in one window): Kernels E and D over
     ragged windows (blocks of different step counts, one active lane,
     the L3 SEQ collision case, L4's match family) against their plain
     versions and against one launch a block, and Kernel C's window
     launch over 88 streams; the window's QUAL through E and D (and
     against their plain versions on the first 64 steps of each block)
     and its 28 streams through C timed on their own inputs, and its
     coder span against its blocks' spans; the window path through
     api.encode_fastq / decode_fastq at level 3 and 4 (the JAX package's
     SHA-256, exact round trips, one C launch a window, E and D once a
     stream group over several blocks; at L3 one 16k block's ratio
     6.2698, at L4 MATCH_USED); walls with the window and one block at a
     time; the window sweep, each window once ({1, 2, 4, 8} on 8 16k
     blocks at L3; on the 4 64k blocks {1, 2, 4} at L3, {1, 4} at L4); in
     a fresh process, the streaming encode (chunks that cut records), a
     resumed truncated copy and the streaming decode, with peak host RSS.
  6. long reads: one block of 65,536 x 16.5 kb reads (raw span past 2
     GiB) through api.encode_fastq / decode_fastq at the defaults: SEQ
     and QUAL packed and unpacked on the host, Kernel E in step slices;
     exact round trip, walls, peak device memory, launches and slices,
     the block's device bytes against the window budget; E over the long
     QUAL's slices, D on its payload and C on its chunk buffers, timed
     beside their bounds, E held against its plain version over 2
     slices; then the pinned block forced through the host-pack path
     (small slices) keeps its SHA-256 at level 3 and level 4, and its
     QUAL in slices equals one launch.
  7. block sharding (parallel.sharded) on make_mesh() (every card) and on
     a mesh naming cuda:0 twice (two shard threads): the pinned block
     keeps both SHA-256 pins; the 4 x 64k set at level 3 and 4 gives
     api.encode_fastq's container, its walls beside the single card's in
     turns, each shard's launches; the 16k set through the streaming
     sharded encode (with a resume) and decode; ragged_all_gather on
     NCCL (world size 1, a fresh process) carrying the 4 blocks' shard
     containers, merged into the whole container; level 1 (tables in
     shared memory) with every SEQ and QUAL stream in step slices equals
     the unforced container, its QUAL in slices equals one launch, and E
     over 2 slices equals its plain version.
  8. the host-side reference paths: the pinned block through the
     pure-Python pipeline (api.encode_fastq / decode_fastq with
     use_native=False: every stream's Kernels E and C, or D, launched one
     stream at a time) at level 3 and 4 keeps both SHA-256 pins and round
     trips, with each direction's launches, host wall and device time
     (torch.profiler); the level-3 block the same way through
     encode_fastq_sharded / decode_fastq_sharded(use_native=False) on
     make_mesh(); a 2,048-read input encoded on the card equals the NumPy
     oracle's container (backend="oracle"), whose encode and decode
     launch no kernel and allocate nothing on the card; and the
     single-stream pack_device / unpack_device on the pinned block's QUAL
     timed beside their byte bounds and held against the pair form.

Prints `compact_block_l3`, `compact_block_l4`, `compact_phase_l3`,
`compact_phase_l4`, `block`, `block_l4`, `wall`, `wall_l4`,
`window_kernels`, `window_walls`, `window_sweep`, `streaming`,
`long_read`, `long_read_kernels`, `sharded`, `sharded_streaming`,
`gather_nccl`, `l1_slices`, `python_pipeline`, `python_pipeline_s`,
`single_stream_pack`, `earlier_ms` (recorded constants),
`phase_s` (seconds a phase) and `kernels` JSON lines, then the card's
name and power limit and, as its last line, the `ok` JSON line.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

# Pinned block (bench.py's shape): 65,536 reads x 100 bp, level 3 and
# level 4.
READS, READ_LEN = 65536, 100
# size and SHA-256 of the JAX package's container for the pinned block
# (its api.encode_fastq(data, level=level, backend=streams_jax), run on a
# CPU), by level
PINNED = {
    3: (2593846,
        "056cae0e9fd312106cae2a401155a533840c167a46ced960fad355c4471a3f6c"),
    4: (2072715,
        "31026796c476744a9da168b3b6132be07d3151b3c7020feeb8790e7a5322470f"),
}
WALL_BLOCKS = 4
# The small-block window path: the same 4-block set (4 x 16,384 records,
# the generator above with 65,536 reads) at block_records = 16,384, coded
# in one window (the default takes all 4); size and SHA-256 of the JAX
# package's container
# (its api.encode_fastq(data, level=level, backend=streams_jax,
# block_records=16384), which runs its own window path, on a CPU)
WINDOW_RECORDS = 16384
PINNED_16K = {
    3: (2937850,
        "0ccf54fbb501fc7fbfa80b09f5abdaac2b1a7a5068977ae17949f58b0072e725"),
    4: (2510237,
        "f93ec9b2a88d24dd733003164590c83eb97f5564da7aa508dc3a427b9a4bfb9c"),
}
STREAM_CHUNK = 3_000_001  # ~12,500 records: chunks cut records and blocks
# The long-read block: 65,536 reads of 16.5 kb (an ordinary PacBio HiFi
# run's lengths), one 65,536-record block whose raw span passes 2 GiB
LONG_READS, LONG_LEN = 65536, 16500
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# the host link of an H100 SXM card: PCIe 5.0 x16, 64 GB/s a direction
# (nominal)
PCIE_BYTES_PER_S = 64e9
# the NumPy oracle's input: the pinned generator's first 2,048 reads
ORACLE_READS = 2048
# Recorded constants, printed on a line of their own (this script, H100
# 80GB HBM3, 700 W): each kernel's time at the timed shape before E and D
# moved their table law into shared memory, and Kernel C on QUAL alone
# when it took one launch per stream (CUDA events around the wrapper)
EARLIER_MS = {"before_smem_table_law": {"lane_encode": 142.01,
                                        "lane_decode": 136.97,
                                        "compact_lanes_dev": 0.0317},
              "one_launch_per_stream": {"compact_lanes_dev": 0.0325}}
BARRIER_ITERS = 200000
# The window forms' plain versions run on the first PLAIN_CHUNKS chunks of
# CHUNK_STEPS symbol steps of each block of the 16k window
CHUNK_STEPS, PLAIN_CHUNKS = 8, 8


def _pinned(reads: int) -> bytes:
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    return synth_fastq(reads, read_len=READ_LEN, seed=0, var_len=False,
                       n_rate=0.0005)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of one call, CUDA events around `reps` calls after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _compare(errs: dict, name: str, what: str, a, b) -> None:
    """Kernel output(s) `a` against the plain version's `b`: records the
    largest absolute difference under `name` and fails unless it is 0."""
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _compare(errs, name, what, x, y)
        return
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape} != {b.shape}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max abs error {err})")


# ---------------------------------------------------------------------------
# phase 3a: kernels against their plain versions at the reduced shape
# ---------------------------------------------------------------------------

def _reads_layout(W: int, Sp: int, read_len: int, active: int):
    """The first `active` lanes hold reads of `read_len` starting at step
    0, the others none: at each read start the active lanes share one
    context (the collision case)."""
    import numpy as np
    ll = np.full((Sp // read_len, W), read_len, dtype=np.int64)
    ll[:, active:] = 0
    return ll, ll.sum(axis=0)


def _match_layout(syms, pos, counts):
    """(e-letter symbols, mflag [Sp, W] u8) of a level-4 SEQ trial: every
    active lane flagged over read positions [20, 90), its symbols there
    mostly 0 (e-transform letters) and all 0 at positions 18-23, so at the
    span's first steps every active lane shares one match-family entry."""
    import numpy as np
    rng = np.random.default_rng(9)
    p = pos.cpu().numpy()
    span = (p >= 20) & (p < 90) & (np.arange(p.shape[0])[:, None]
                                   < counts[None, :])
    e = np.where(rng.random(syms.shape) < 0.9, 0, syms)
    out = np.where(span, e, syms).astype(np.uint8)
    out[(p >= 18) & (p < 24)] = 0
    return out, span.astype(np.uint8)


def _check_stream(kind, geom, syms_np, counts_np, pos, reset, dev, plain,
                  errs, mflag_np=None):
    """E, C and D on the card against their plain versions for one stream
    (mflag_np: a level-4 SEQ stream's match-span flags). Records the plain
    versions' times (ms) at this shape in `plain` and each kernel's
    largest difference in `errs`."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    Sp, W = syms_np.shape
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(dev)
    counts = torch.from_numpy(counts_np.astype(np.int32)).to(dev)
    mflag = None if mflag_np is None else torch.from_numpy(mflag_np).to(dev)
    idx_c, bit_c = ST._schedule(kind, geom, syms, pos, reset, counts, mflag)
    CB = ST._chunk_bytes(geom.depth, hard=False)
    enc_k = coder_torch.lane_encode(idx_c, bit_c, geom, CB)
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc_p = coder_torch.lane_encode_plain(idx_c, bit_c, geom, CB)
    torch.cuda.synchronize()
    plain["lane_encode"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_encode", f"lane_encode {kind} W={W}", enc_k,
             enc_p)
    ebufs, eptrs, low, emax = enc_k
    if int(emax) > CB:
        raise AssertionError(f"{kind}: optimistic chunk buffer overflowed")
    Bmax = max(int(eptrs.sum(dim=0).max()), 1)
    com_k = compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax)
    torch.cuda.synchronize()
    t = time.perf_counter()
    com_p = compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax)
    torch.cuda.synchronize()
    plain["compact_lanes_dev"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "compact_lanes_dev", f"compact {kind} W={W}", com_k,
             com_p)
    pay, lens = ST._flush_append(com_k[0].cpu().numpy(),
                                 com_k[1].cpu().numpy().astype(np.int64),
                                 low.cpu().numpy().view(np.uint32),
                                 counts_np)
    args = (torch.from_numpy(pay).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev),
            ST._acts(counts, Sp), pos, reset)
    dec_k = coder_torch.lane_decode(*args, kind, geom, mflag)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec_p = coder_torch.lane_decode_plain(*args, kind, geom, mflag)
    torch.cuda.synchronize()
    plain["lane_decode"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_decode", f"lane_decode {kind} W={W}", dec_k,
             dec_p)
    mask = np.arange(Sp)[:, None] < counts_np[None, :]
    if not np.array_equal(dec_k.cpu().numpy()[mask], syms_np[mask]):
        raise AssertionError(f"{kind}: decode does not invert encode")


def check_kernels(dev):
    """All four coder kinds, and level 4's SEQ with the match-context
    family and QUAL with the q1-q2 delta. Returns the plain versions' times
    in the QUAL case (the longest chain) at W = 1024, Sp = 256 and each
    kernel's largest absolute difference from its plain version, then the
    same at level 4 (times in the 1,024-lane SEQ case)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(3)
    rng = np.random.default_rng(7)
    Sp, W = 256, 1024
    seq = rng.integers(0, 4, size=(Sp, W)).astype(np.uint8)
    steps = rng.integers(-2, 3, size=(Sp, W))
    qual = np.clip(30 + np.cumsum(steps, axis=0), 0, 41).astype(np.uint8)
    plain_qual, errs = {}, {}
    # 700 lanes on one entry read a negative count, 1,024 a count of 0
    for active in (700, W):
        ll, counts = _reads_layout(W, Sp, READ_LEN, active)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        _check_stream("seq", cfg.seq, seq, counts, pos, reset, dev, {},
                      errs)
    _check_stream("qual", cfg.qual, qual, counts, pos, reset, dev,
                  plain_qual, errs)
    Wa = cfg.aux_lanes
    zeros = torch.zeros((Sp, Wa), dtype=torch.int32, device=dev)
    ragged = rng.integers(Sp // 2, Sp + 1, size=Wa)
    _check_stream("byte", cfg.bytes_,
                  rng.integers(0, 256, size=(Sp, Wa)).astype(np.uint8),
                  ragged, zeros, zeros, dev, {}, errs)
    _check_stream("flag", cfg.flags,
                  rng.integers(0, 2, size=(Sp, Wa)).astype(np.uint8),
                  ragged, zeros, zeros, dev, {}, errs)
    cfg4, errs4, plain_seq4 = config_for_level(4), {}, {}
    for active in (700, W):  # every active lane flagged on one entry
        ll, counts = _reads_layout(W, Sp, READ_LEN, active)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        e_syms, mflag = _match_layout(seq, pos, counts)
        _check_stream("seq", cfg4.seq, e_syms, counts, pos, reset, dev,
                      plain_seq4, errs4, mflag)
    _check_stream("qual", cfg4.qual, qual, counts, pos, reset, dev, {},
                  errs4)
    print(f"kernels match their plain versions: seq (1,024 and 700 "
          f"colliding lanes)/qual at W={W} Sp={Sp}, byte/flag at W={Wa} "
          f"Sp={Sp}; level 4: seq with the match family (1,024 and 700 "
          f"flagged lanes on one entry), qual with the q1-q2 delta",
          flush=True)
    return plain_qual, errs, plain_seq4, errs4


# ---------------------------------------------------------------------------
# phase 3b: kernel times on the main path's own inputs
# ---------------------------------------------------------------------------

def time_kernels(data: bytes, dev, errs: dict) -> dict:
    """Device times (ms) and byte bounds of E and D on the pinned block's
    QUAL stream (the longest serial chain of the block), whose inputs come
    from the main path's own setup (pipeline_native.prepare_block_fast,
    streams_torch.seq_qual_jobs). At this size C (one stream) is also held
    against its plain version (recorded in `errs`) and D's output against
    the packed QUAL symbols."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.pipeline_native import (prepare_block_fast,
                                                     seq_qual_args)
    cfg = config_for_level(3)
    idx, n = native.fastq_index(data)
    pre = prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0, n,
                             cfg)
    q = next(j for j in ST.seq_qual_jobs(*seq_qual_args(pre, cfg), dev)
             if j.name == "QUAL")
    Sp, W = q.syms.shape
    NC, KD, _ = q.idx_c.shape
    out = {"shape": {"W": W, "Sp": Sp, "NC": NC, "depth": q.geom.depth},
           "bit_steps": NC * KD}
    CB = ST._chunk_bytes(q.geom.depth, hard=False)
    ebufs, eptrs, low, emax = coder_torch.lane_encode(q.idx_c, q.bit_c,
                                                      q.geom, CB)
    if int(emax) > CB:
        raise AssertionError("QUAL: optimistic chunk buffer overflowed")
    e_ms = _time_ms(lambda: coder_torch.lane_encode(q.idx_c, q.bit_c, q.geom,
                                                    CB), 3)
    e_bytes = 2 * q.idx_c.numel() * 4 + ebufs.numel() + eptrs.numel() * 4 \
        + W * 4
    totals = eptrs.sum(dim=0)
    Bmax = int(totals.max())
    com_k = compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax)
    _compare(errs, "compact_lanes_dev", f"compact qual NC={NC} W={W}", com_k,
             compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax))
    pay, lens = ST._flush_append(com_k[0].cpu().numpy(),
                                 totals.cpu().numpy().astype(np.int64),
                                 low.cpu().numpy().view(np.uint32),
                                 q.counts.cpu().numpy())
    acts = ST._acts(q.counts, Sp)
    dargs = (torch.from_numpy(pay).to(dev),
             torch.from_numpy(lens.astype(np.int32)).to(dev), acts, q.pos,
             q.reset)
    dec = coder_torch.lane_decode(*dargs, "qual", q.geom)
    mask = acts.bool()
    if not torch.equal(dec[mask].int(), q.syms[mask]):
        raise AssertionError("lane_decode of the pinned block's QUAL stream "
                             "does not return its packed symbols")
    d_ms = _time_ms(lambda: coder_torch.lane_decode(*dargs, "qual", q.geom),
                    3)
    d_bytes = pay.size + W * 4 + 3 * Sp * W * 4 + Sp * W
    out["lane_encode"] = (e_ms, e_bytes)
    out["lane_decode"] = (d_ms, d_bytes)
    print(f"kernels at the main path's shape: compact equals its plain "
          f"version (NC={NC}, W={W}), decode returns the packed QUAL "
          f"symbols", flush=True)
    return out


def time_kernels_l4(data: bytes, dev, errs4: dict) -> dict:
    """Device times (ms) and byte bounds of E and D on the pinned
    block's level-4 SEQ stream as the block codes it: the winning match
    trial's e-letters and flags, the order-11 table (pipeline_native's own
    setup). Also the host's share of a level-4 block: the matcher and the
    trials' rewritten copies (host clock). D's output is held against the
    packed trial symbols, C (one stream) against its plain version
    (`errs4`)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.models import matcher as M
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    cfg = config_for_level(4)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    host = {}
    t = time.perf_counter()
    PN.prepare_block_fast(buf, idx, 0, n, config_for_level(3))
    host["prep_l3_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pre = PN.prepare_block_fast(buf, idx, 0, n, cfg)
    host["prep_l4_ms"] = (time.perf_counter() - t) * 1e3
    lengths = idx["seq_len"].astype(np.int64)
    t = time.perf_counter()
    matches = native.match_find_arrays(buf, idx["seq_off"], lengths,
                                       min(M.THRESHOLDS))
    host["match_find_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    trials = PN._match_trials(matches, pre[5], cfg.lanes, cfg.aux_lanes,
                              int(pre[4].sum(0).max()))
    host["trials_ms"] = (time.perf_counter() - t) * 1e3
    host["trials"] = [tr[0] for tr in trials]
    blk = PN.encode_prepared_block(pre, cfg, dev)
    if not blk.flags & MATCH_USED:
        raise AssertionError("the pinned level-4 block takes no match trial")
    # the trial the block kept: its SEQ bytes are the block's
    for t_, alt, _, _, mflag in pre[6]["trials"]:
        job = next(ST.seq_qual_jobs(*PN.seq_qual_args(pre, cfg, alt), dev,
                                    mflag, ("SEQ",)))
        pay, _ = ST.encode_block([("SEQ", "seq", job.geom, job.idx_c,
                                    job.bit_c, pre[0]["SEQ"][3])],
                                 dev)["SEQ"]
        if np.array_equal(pay, blk.streams["SEQ"].payload):
            break
    else:
        raise AssertionError("no trial gives the block's SEQ stream")
    host["winner"] = t_
    Sp, W = job.syms.shape
    NC, KD, _ = job.idx_c.shape
    out = {"shape": {"W": W, "Sp": Sp, "NC": NC, "depth": job.geom.depth,
                     "order": job.geom.order,
                     "table_entries": job.geom.table_size},
           "bit_steps": NC * KD, "host": host}
    CB = ST._chunk_bytes(job.geom.depth, hard=False)
    ebufs, eptrs, low, emax = coder_torch.lane_encode(job.idx_c, job.bit_c,
                                                      job.geom, CB)
    if int(emax) > CB:
        raise AssertionError("L4 SEQ: optimistic chunk buffer overflowed")
    e_ms = _time_ms(lambda: coder_torch.lane_encode(
        job.idx_c, job.bit_c, job.geom, CB), 3)
    e_bytes = 2 * job.idx_c.numel() * 4 + ebufs.numel() + eptrs.numel() * 4 \
        + W * 4
    totals = eptrs.sum(dim=0)
    Bmax = int(totals.max())
    _compare(errs4, "compact_lanes_dev", f"compact L4 seq NC={NC} W={W}",
             compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax),
             compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax))
    mf = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
    mf[: mflag.shape[0]] = torch.from_numpy(mflag).to(dev)
    dargs = (ST._payload_tensor(blk.streams["SEQ"].payload, dev),
             ST._to(blk.streams["SEQ"].lane_lens, dev, torch.int32),
             ST._acts(job.counts, Sp), job.pos, job.reset)
    dec = coder_torch.lane_decode(*dargs, "seq", job.geom, mf)
    mask = dargs[2].bool()
    if not torch.equal(dec[mask].int(), job.syms[mask]):
        raise AssertionError("lane_decode of the pinned block's L4 SEQ "
                             "stream does not return its trial symbols")
    d_ms = _time_ms(lambda: coder_torch.lane_decode(*dargs, "seq", job.geom,
                                                    mf), 3)
    d_bytes = dargs[0].numel() + W * 4 + 3 * Sp * W * 4 + 2 * Sp * W
    out["lane_encode"] = (e_ms, e_bytes)
    out["lane_decode"] = (d_ms, d_bytes)
    print(f"L4 kernels at the main path's shape: the block keeps trial "
          f"t={t_}; compact equals its plain version, decode returns the "
          f"trial's symbols; host {json.dumps(host)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3c: Kernel C, one launch for all of a block's streams
# ---------------------------------------------------------------------------

C_KERNEL = "compact_streams_kernel"
# (NC, W, CB, count cap, Bmax past the longest lane) of the ragged mix held
# in one launch: W of 8, 64, 100 and 1024; NC not a multiple of the
# kernel's 128-chunk tile; counts above CB; a lane of zeros in each; an
# all-empty stream; rows longer than one shared-memory stage (27,904 bytes)
RAGGED = [(300, 8, 32, 40, 5), (129, 64, 48, 48, 0), (77, 100, 16, 24, 3),
          (800, 1024, 64, 4, 0), (5, 64, 16, 0, 1), (1600, 100, 32, 40, 9)]


def _device_ms(fn, reps: int, key: str) -> float:
    """Mean device time (ms) of a launch of the kernel whose name holds
    `key`, from torch.profiler's kernel records over `reps` calls of fn
    (one launch each) after one warm-up call. The profiler may drop
    records (a run on the H100 kept 8 of 20): the mean is over the records
    it kept, and there must be one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            total += e.self_device_time_total / 1e3
            n += e.count
    if not 1 <= n <= reps:
        raise AssertionError(f"the profiler kept {n} records of {key} for "
                             f"{reps} launches")
    return total / n


def _c_bytes(streams, sector: int = 1) -> int:
    """Kernel C's byte bound over a launch: each stream's valid bytes, its
    [NC, W] counts, its [W, pitch] rows and its totals. With sector=32,
    each window's valid bytes count as the 32-byte sectors they fill: the
    least the reads can move."""
    total = 0
    for ebufs, eptrs, Bmax in streams:
        NC, W, CB = ebufs.shape
        valid = (eptrs.clamp(max=CB).long() + sector - 1) // sector * sector
        total += int(valid.sum()) + eptrs.numel() * 4 \
            + W * ((Bmax + 15) // 16 * 16) + W * 4
    return total


def check_ragged(dev, errs: dict) -> None:
    """Kernel C's one launch over the ragged mix (with a tail per stream)
    against compact_streams_plain, the whole flat buffer byte for byte."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import compact_torch as CC
    rng = np.random.default_rng(3)
    streams = []
    for NC, W, CB, cap, extra in RAGGED:
        eptrs = rng.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
        eptrs[:, W // 3] = 0
        ebufs = rng.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
        streams.append((torch.from_numpy(ebufs).to(dev),
                        torch.from_numpy(eptrs).to(dev),
                        max(int(eptrs.sum(axis=0).max()) + extra, 1)))
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev) - 9
             for _, ep, _ in streams]
    _compare(errs, "compact_lanes_dev", "compact, the ragged mix in one "
             "launch", CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    print(f"compact: one launch over {len(streams)} ragged streams (W "
          f"{sorted({s[0].shape[1] for s in streams})}, rows up to "
          f"{max(s[2] for s in streams)} bytes) equals its plain version",
          flush=True)


def block_compaction(data: bytes, dev, level: int, errs: dict) -> dict:
    """Kernel C on the pinned block's coded streams at `level` as
    encode_block hands them over (pipeline_native._coder_jobs, Kernel E's
    outputs and coder tails): the one launch held against
    compact_streams_plain byte for byte, and again with QUAL coded at the
    hard chunk size (encode_block's rerun), which must give QUAL's same
    payload and totals; then the launch's device time (profiler kernel
    records) and its wrapper-inclusive time (CUDA events around
    compact_streams_dev) beside its byte bound, its plain version's time,
    and at level 3 the same for QUAL alone (one stream a launch, as
    Kernel C ran before it took a block's streams at once)."""
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(level)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    names, streams, tails = [], [], []
    for name, kind, geom, idx_c, bit_c, _ in PN._coder_jobs(pre, cfg, dev):
        CB = ST._chunk_bytes(geom.depth, hard=False)
        ebufs, eptrs, low, emax = coder_torch.lane_encode(idx_c, bit_c, geom,
                                                          CB)
        if int(emax) > CB:
            raise AssertionError(f"L{level} {name}: optimistic chunk buffer "
                                 "overflowed")
        if name == "QUAL":
            hard = coder_torch.lane_encode(
                idx_c, bit_c, geom, ST._chunk_bytes(geom.depth, hard=True))
        names.append(name)
        tails.append(low)
        streams.append((ebufs, eptrs, max(int(eptrs.sum(dim=0).max()), 1)))
    what = f"compact L{level} block ({len(streams)} streams)"
    flat, layout = CC.compact_streams_dev(streams, tails)
    _compare(errs, "compact_lanes_dev", what, flat,
             CC.compact_streams_plain(streams, tails)[0])
    q = names.index("QUAL")
    hard_streams = list(streams)
    hard_streams[q] = (hard[0], hard[1], streams[q][2])
    hflat, hlayout = CC.compact_streams_dev(hard_streams, tails)
    _compare(errs, "compact_lanes_dev", f"{what}, QUAL at the hard CB",
             hflat, CC.compact_streams_plain(hard_streams, tails)[0])
    _compare({}, "compact_lanes_dev", f"{what}: QUAL at the hard CB against "
             "the optimistic CB", hlayout.views(hflat)[q][:2],
             layout.views(flat)[q][:2])

    def launch():
        return CC.compact_streams_dev(streams, tails)
    nbytes = _c_bytes(streams)
    out = {"streams": names, "device_ms": _device_ms(launch, 20, C_KERNEL),
           "wrapper_ms": _time_ms(launch, 20),
           "plain_ms": _time_ms(lambda: CC.compact_streams_plain(
               streams, tails), 3),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "sector_bound_ms": _c_bytes(streams, 32) / HBM_BYTES_PER_S * 1e3}
    out["bound_fraction"] = out["bound_ms"] / out["device_ms"]
    if level == 3:  # like for like with the one-launch-per-stream kernel
        qs = streams[q]
        qbound = _c_bytes([qs]) / HBM_BYTES_PER_S * 1e3
        qdev = _device_ms(lambda: CC.compact_lanes_dev(*qs), 20, C_KERNEL)
        out["qual_alone"] = {
            "device_ms": qdev,
            "wrapper_ms": _time_ms(lambda: CC.compact_lanes_dev(*qs), 20),
            "bound_ms": qbound, "bound_fraction": qbound / qdev,
            "shape": {"NC": int(qs[0].shape[0]), "W": int(qs[0].shape[1]),
                      "CB": int(qs[0].shape[2]), "Bmax": qs[2]}}
    print(json.dumps({f"compact_block_l{level}": out}), flush=True)
    return out


def barrier_us(dev) -> float:
    """One 1,024-thread __syncthreads() on the card (us): csrc/coder.cu's
    barrier_loop, CUDA events around BARRIER_ITERS barriers, less a launch
    of none."""
    import torch
    from slimfastq_tpu_torch.ops import _cuda, coder_torch
    lib = _cuda.load("coder", coder_torch._SIGS)
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(iters):
        _cuda.check(lib, _cuda.launch(out, lib.barrier_loop, iters, 1024,
                                      out.data_ptr()), "barrier_loop")
    full = _time_ms(lambda: run(BARRIER_ITERS), 3)
    empty = _time_ms(lambda: run(0), 3)
    return (full - empty) * 1e3 / BARRIER_ITERS


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(data: bytes, level: int) -> dict:
    """The pinned block through api.encode_fastq / decode_fastq at
    `level`, the launch counts set to 0 just before and read just after.
    At level 4 the block must take a match trial (MATCH_USED)."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    _cuda.reset_launches()
    enc = api.encode_fastq(data, level=level, device="cuda")
    dec = api.decode_fastq(enc, device="cuda")
    launches = dict(_cuda.launches)
    descs = dict(_cuda.descs)
    nbytes, want_sha = PINNED[level]
    if len(enc) != nbytes:
        raise AssertionError(f"L{level} container is {len(enc)} bytes, "
                             f"expected {nbytes}")
    sha = hashlib.sha256(enc).hexdigest()
    if sha != want_sha:
        raise AssertionError(f"L{level} container SHA-256 {sha} differs "
                             "from the JAX package's")
    if dec != data:
        raise AssertionError(f"L{level} decode does not return the input")
    idle = [k for k in ("lane_encode", "lane_decode", "compact_lanes_dev")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the L{level} main "
                             f"path: {idle}")
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
    if level == 4 and not all(fl & MATCH_USED for fl in flags):
        raise AssertionError(f"L4 block flags {flags}: no MATCH_USED")
    print(f"main path L{level}: {len(data)} raw -> {len(enc)} bytes (ratio "
          f"{len(data) / len(enc):.4f}), SHA-256 equals the JAX package's, "
          f"block flags {flags}, round trip exact, launches {launches} "
          f"(descriptors {descs})", flush=True)
    return launches


def _events_ms(fn):
    """(ms between CUDA events on the calling stream around fn(), its
    result), after the card is idle."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def block_spans(data: bytes, dev) -> dict:
    """The pinned block's seven coder launches per direction, with the
    inputs the main path gives them (pipeline_native's own setup): each
    stream's E and D time (ms) alone, and the block's coder span, its
    streams launched at once through streams_torch.StreamSet as the main
    path launches them, from the calling stream's event before the first
    launch to its event after the join. The main path decodes LEN first
    and the rest once the host has read its lengths; here the seven
    decodes start together, so the decode span leaves out that host step.
    `device_half_ms` times the main path's own device halves
    (pipeline_native.encode_prepared_block, decode_block_device) with
    events on the calling stream: schedules, packing, compaction and the
    host's reads and flush included. The launches at once must give what
    the launches alone give."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    cfg = config_for_level(3)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    jobs = list(PN._coder_jobs(pre, cfg, dev))
    ll_mat = pre[4]
    enc_ms, blk = _events_ms(lambda: PN.encode_prepared_block(pre, cfg, dev))
    dec_ms, _ = _events_ms(lambda: PN.decode_block_device(blk, cfg, dev))
    launches = {"encode": {}, "decode": {}}
    for name, kind, geom, idx_c, bit_c, _counts in jobs:
        CB = ST._chunk_bytes(geom.depth, hard=False)
        launches["encode"][name] = (
            lambda idx_c=idx_c, bit_c=bit_c, geom=geom, CB=CB:
            coder_torch.lane_encode(idx_c, bit_c, geom, CB), (idx_c, bit_c))
        es = blk.streams[name]
        W = es.payload.shape[0]
        counts = ST._to(es.sym_counts, dev, torch.int32)
        S = int(es.sym_counts.max())
        Sp = pad_steps(S)
        if kind in ("seq", "qual"):
            pos, reset = ST._pos_reset(ST._lane_lens(ll_mat, W, dev), Sp, S,
                                       W)
        else:
            pos = reset = ST._pad2(None, Sp, W, dev)
        args = (ST._payload_tensor(es.payload, dev),
                ST._to(es.lane_lens, dev, torch.int32), ST._acts(counts, Sp),
                pos, reset)
        launches["decode"][name] = (
            lambda args=args, kind=kind, geom=geom:
            coder_torch.lane_decode(*args, kind, geom), args)
    out = {}
    for direction, fns in launches.items():
        alone = {k: _time_ms(fn, 1) for k, (fn, _) in fns.items()}
        ss = ST.StreamSet(dev)

        def at_once():
            res = [ss.launch(fn, *inputs)[0] for fn, inputs in fns.values()]
            ss.join()
            return res
        span, res = _events_ms(at_once)
        for (name, (fn, _)), got in zip(fns.items(), res):
            _compare({}, name, f"{direction} {name}: launched at once vs "
                     "alone", got, fn())
        total = sum(alone.values())
        out[direction] = {"span_ms": span, "sum_ms": total,
                          "span_below_sum": span < total,
                          "streams_ms": alone,
                          "device_half_ms": (enc_ms if direction == "encode"
                                             else dec_ms)}
    print(json.dumps({"block": out}), flush=True)
    return out


def l4_spans(data: bytes, dev) -> dict:
    """The pinned level-4 block's encode launches (QUAL, the plain SEQ, each
    match trial's SEQ@t and MATCH@t, the aux streams) on the main path's
    inputs: each alone, and the block's coder span in two orders, all at
    once (the main path's) and each trial's SEQ queued behind the plain
    SEQ on one CUDA stream (at most one order-11 SEQ table in use at a
    time), in turns (at once, serial, serial, at once); both must give
    the bytes of the launches alone. Also the main path's device halves
    at level 4, CUDA events on the calling stream."""
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(4)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    enc_ms, blk = _events_ms(lambda: PN.encode_prepared_block(pre, cfg, dev))
    dec_ms, _ = _events_ms(lambda: PN.decode_block_device(blk, cfg, dev))
    fns = {}
    for name, kind, geom, idx_c, bit_c, _counts in PN._coder_jobs(pre, cfg,
                                                                  dev):
        CB = ST._chunk_bytes(geom.depth, hard=False)
        fns[name] = (lambda idx_c=idx_c, bit_c=bit_c, geom=geom, CB=CB:
                     coder_torch.lane_encode(idx_c, bit_c, geom, CB),
                     (idx_c, bit_c))
    alone = {k: _time_ms(fn, 1) for k, (fn, _) in fns.items()}

    def launch(serial: bool):
        ss = ST.StreamSet(dev)
        res, seq_stream = [], None
        for name, (fn, inputs) in fns.items():
            trial = serial and name.startswith("SEQ@")
            out, s = ss.launch(fn, *inputs,
                               after=seq_stream if trial else None)
            if name == "SEQ":
                seq_stream = s
            res.append(out)
        ss.join()
        return res
    spans = {"at_once_ms": [], "serial_ms": []}
    for serial in (False, True, True, False):
        span, res = _events_ms(lambda: launch(serial))
        spans["serial_ms" if serial else "at_once_ms"].append(span)
        for (name, (fn, _)), got in zip(fns.items(), res):
            _compare({}, name, f"L4 encode {name}: launched at once vs "
                     "alone", got, fn())
    out = {"streams_ms": alone, "sum_ms": sum(alone.values()), **spans,
           "device_half_ms": {"encode": enc_ms, "decode": dec_ms}}
    print(json.dumps({"block_l4": out}), flush=True)
    return out


def wall(data: bytes, dev, level: int) -> None:
    """Encode and decode wall time of `data`, the 4-block set, at
    `level`."""
    import torch
    from slimfastq_tpu_torch import api
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=level, device=dev)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device=dev)
    t_dec = time.perf_counter() - t
    if dec != data:
        raise AssertionError(f"L{level} 4-block round trip is not exact")
    print(json.dumps({"wall" if level == 3 else f"wall_l{level}": {
        "level": level, "blocks": WALL_BLOCKS, "raw_bytes": len(data),
        "compressed_bytes": len(enc), "ratio": len(data) / len(enc),
        "encode_s": t_enc, "decode_s": t_dec,
        "encode_GBps": len(data) / t_enc / 1e9,
        "decode_GBps": len(data) / t_dec / 1e9}}), flush=True)


# ---------------------------------------------------------------------------
# phase 5: the small-block window path (16,384-record blocks in windows)
# ---------------------------------------------------------------------------

def _window_stream(kind, rng, Sp: int, W: int, active, read_len: int = 32):
    """(syms [Sp, W] u8, counts) of one block of a ragged window: reads of
    `read_len` from step 0 in the first `active` lanes (all at one context
    at each read start: the collision case) for seq/qual, ragged counts
    for byte."""
    import numpy as np
    if kind == "byte":
        return (rng.integers(0, 256, size=(Sp, W)).astype(np.uint8),
                rng.integers(1, Sp + 1, size=W))
    ll, counts = _reads_layout(W, Sp, read_len, W if active is None
                               else active)
    if kind == "seq":
        syms = rng.integers(0, 4, size=(Sp, W))
    else:
        syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, size=(Sp, W)),
                                      axis=0), 0, 41)
    return syms.astype(np.uint8), counts, ll


# (level, kind, W, [(Sp, active lanes)], match family) of the ragged
# windows: blocks of different step counts, a block with one active lane,
# the level-3 SEQ collision case (1,024 and 700 lanes), level 4's match
# family
WINDOWS = [(3, "seq", 1024, [(128, None), (256, 700), (64, 1)], False),
           (3, "qual", 1024, [(160, None), (64, 1), (128, 900)], False),
           (4, "seq", 1024, [(128, None), (192, 700), (32, 1)], True),
           (3, "byte", 64, [(128, None), (32, None), (256, None)], False)]


def check_windows(dev, errs: dict) -> None:
    """Kernels E and D over each ragged window in one launch (one CTA a
    block) against their plain versions and against one launch per block,
    byte for byte; D's output against the coded symbols; then Kernel C's
    window launch over 88 streams (a window of 8 level-4 blocks with their
    trials) against its plain version. Records each batched form's
    largest difference in `errs`."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    rng = np.random.default_rng(11)
    for level, kind, W, blocks, match in WINDOWS:
        cfg = config_for_level(level)
        geom = {"seq": cfg.seq, "qual": cfg.qual, "byte": cfg.bytes_}[kind]
        scheds, inputs = [], []
        for Sp, active in blocks:
            made = _window_stream(kind, rng, Sp, W, active)
            syms, counts = made[0], made[1]
            if kind == "byte":
                pos = reset = torch.zeros((Sp, W), dtype=torch.int32,
                                          device=dev)
            else:
                pos, reset = ST._pos_reset(torch.from_numpy(made[2]).to(dev),
                                           Sp, int(counts.max()), W)
            mflag = None
            if match:
                syms, mf = _match_layout(syms, pos, counts)
                mflag = torch.from_numpy(mf).to(dev)
            s = torch.from_numpy(syms.astype(np.int32)).to(dev)
            c = torch.from_numpy(counts.astype(np.int32)).to(dev)
            scheds.append(ST._schedule(kind, geom, s, pos, reset, c, mflag))
            inputs.append((s, counts, c, pos, reset, mflag))
        CB = ST._chunk_bytes(geom.depth, hard=False)
        what = f"L{level} {kind} window of {len(blocks)}"
        enc = CT.lane_encode_blocks(scheds, geom, CB)
        _compare(errs, "lane_encode_blocks", f"{what}: E vs plain", enc,
                 CT.lane_encode_blocks_plain(scheds, geom, CB))
        _compare({}, "lane_encode_blocks", f"{what}: E vs one launch a "
                 "block", enc, [CT.lane_encode(*sc, geom, CB)
                                for sc in scheds])
        items = []
        for (s, counts, c, pos, reset, mflag), e in zip(inputs, enc):
            if int(e[3]) > CB:
                raise AssertionError(f"{what}: optimistic chunk buffer "
                                     "overflowed")
            Bmax = max(int(e[1].sum(dim=0).max()), 1)
            pay, tot = CC.compact_lanes_dev(e[0], e[1], Bmax)
            pay, lens = ST._flush_append(
                pay.cpu().numpy(), tot.cpu().numpy().astype(np.int64),
                e[2].cpu().numpy().view(np.uint32), counts)
            items.append((ST._payload_tensor(pay, dev),
                          torch.from_numpy(lens.astype(np.int32)).to(dev),
                          ST._acts(c, s.shape[0]), pos, reset, mflag))
        dec = CT.lane_decode_blocks(items, kind, geom)
        _compare(errs, "lane_decode_blocks", f"{what}: D vs plain", dec,
                 CT.lane_decode_blocks_plain(items, kind, geom))
        _compare({}, "lane_decode_blocks", f"{what}: D vs one launch a "
                 "block", dec, [CT.lane_decode(*it[:5], kind, geom, it[5])
                                for it in items])
        for d, (s, _, c, *_r) in zip(dec, inputs):
            mask = torch.arange(s.shape[0], device=dev)[:, None] < c[None, :]
            if not torch.equal(d[mask].int(), s[mask]):
                raise AssertionError(f"{what}: decode does not invert "
                                     "encode")
    streams = []
    for seed in range(15):
        r = np.random.default_rng(seed)
        for NC, W, CB, cap, extra in RAGGED[:6]:
            eptrs = r.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
            ebufs = r.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
            streams.append((torch.from_numpy(ebufs).to(dev),
                            torch.from_numpy(eptrs).to(dev),
                            max(int(eptrs.sum(axis=0).max()) + extra, 1)))
    streams = streams[:88]
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev)
             for _, ep, _ in streams]
    _compare(errs, "compact_window", "Kernel C's window launch over 88 "
             "streams", CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    print(f"window kernels: E and D over {len(WINDOWS)} ragged windows "
          f"equal their plain versions and one launch a block; Kernel C's "
          f"window launch over {len(streams)} streams equals its plain "
          f"version", flush=True)


def _window_pres(data: bytes, level: int, block_records: int):
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    cfg = config_for_level(level, block_records=block_records)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    return cfg, [PN.prepare_block_fast(buf, idx, lo,
                                       min(lo + block_records, n), cfg)
                 for lo in range(0, n, block_records)]


def time_window(data: bytes, dev, bar_us: float, errs: dict) -> dict:
    """The batched launches on the 16k L3 window's own inputs
    (pipeline_native._window_jobs, 4 blocks of 16,384 records): E over the
    window's QUAL (the longest chain) timed with CUDA events beside one
    launch a block; D over the same, its output against the packed
    symbols; E and D against their plain versions on the first
    PLAIN_CHUNKS chunks of each block of the same inputs (the plain
    versions step in Python), both timed there; Kernel C's window launch
    over every coded stream of the 4 blocks (28) against its plain
    version, its device time (profiler records) and its wrapper time
    beside its byte bound; then the window's coder span (every group's E
    launched at once, as the main path launches them) against the sum of
    its blocks' spans, each block's groups launched at once alone."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg, pres = _window_pres(data, 3, WINDOW_RECORDS)
    groups = list(PN._window_jobs(pres, cfg, dev))
    q = next(g for g in groups if g[0] == "QUAL")
    geom = q[2]
    scheds = [(m[1], m[2]) for m in q[3]]
    CB = ST._chunk_bytes(geom.depth, hard=False)
    enc = CT.lane_encode_blocks(scheds, geom, CB)
    e_ms = _time_ms(lambda: CT.lane_encode_blocks(scheds, geom, CB), 3)
    e_one = sum(_time_ms(lambda sc=sc: CT.lane_encode(*sc, geom, CB), 1)
                for sc in scheds)
    e_bytes = sum(2 * i.numel() * 4 + e[0].numel() + e[1].numel() * 4
                  + e[2].numel() * 4 for (i, _), e in zip(scheds, enc))
    items, syms_ref = [], []
    for pre, e, (_, i, _, counts) in zip(pres, enc, q[3]):
        Bmax = max(int(e[1].sum(dim=0).max()), 1)
        pay, tot = CC.compact_lanes_dev(e[0], e[1], Bmax)
        pay, lens = ST._flush_append(pay.cpu().numpy(),
                                     tot.cpu().numpy().astype(np.int64),
                                     e[2].cpu().numpy().view(np.uint32),
                                     np.asarray(counts))
        job = next(ST.seq_qual_jobs(*PN.seq_qual_args(pre, cfg), dev))
        Sp = job.syms.shape[0]
        items.append((torch.from_numpy(pay).to(dev),
                      torch.from_numpy(lens.astype(np.int32)).to(dev),
                      ST._acts(job.counts, Sp), job.pos, job.reset))
        syms_ref.append(job.syms)
    dec = CT.lane_decode_blocks(items, "qual", geom)
    for d, s, it in zip(dec, syms_ref, items):
        mask = it[2].bool()
        if not torch.equal(d[mask].int(), s[mask]):
            raise AssertionError("the window's QUAL decode does not return "
                                 "its packed symbols")
    # the plain versions on a prefix of every block: E on its first chunks,
    # D on their steps (a prefix decodes exactly from the whole payload)
    n_steps = CHUNK_STEPS * PLAIN_CHUNKS
    pre_e = [(i[:PLAIN_CHUNKS], b[:PLAIN_CHUNKS]) for i, b in scheds]
    pre_d = [(p, ln, *(x[:n_steps] for x in rest))
             for p, ln, *rest in items]
    plain, prefix_ms = {}, {}
    for name, args, kernel, plain_fn in (
            ("lane_encode_blocks", pre_e,
             lambda a: CT.lane_encode_blocks(a, geom, CB),
             lambda a: CT.lane_encode_blocks_plain(a, geom, CB)),
            ("lane_decode_blocks", pre_d,
             lambda a: CT.lane_decode_blocks(a, "qual", geom),
             lambda a: CT.lane_decode_blocks_plain(a, "qual", geom))):
        got = kernel(args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = plain_fn(args)
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t) * 1e3
        _compare(errs, name, f"{name}: the 16k L3 window's QUAL, the first "
                 f"{n_steps} steps of each block", got, want)
        prefix_ms[name] = _time_ms(lambda a=args, k=kernel: k(a), 3)
    d_ms = _time_ms(lambda: CT.lane_decode_blocks(items, "qual", geom), 3)
    d_one = sum(_time_ms(lambda it=it: CT.lane_decode(*it, "qual", geom), 1)
                for it in items)
    steps = max(i.shape[0] * i.shape[1] for i, _ in scheds)
    # Kernel C over the window's coded streams, as encode_window hands them
    streams, tails = [], []
    for _, _, g, members in groups:
        cb = ST._chunk_bytes(g.depth, hard=False)
        for e in CT.lane_encode_blocks([(m[1], m[2]) for m in members], g,
                                       cb):
            if int(e[3]) > cb:
                raise AssertionError("window: optimistic chunk buffer "
                                     "overflowed")
            streams.append((e[0], e[1], max(int(e[1].sum(dim=0).max()), 1)))
            tails.append(e[2])
    _compare(errs, "compact_window", f"Kernel C: the 16k L3 window's "
             f"{len(streams)} streams",
             CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    c_bytes = _c_bytes(streams)

    def run(gs):
        ss = ST.StreamSet(dev)
        outs = [ss.launch(lambda g=g: CT.lane_encode_blocks(
            [(m[1], m[2]) for m in g[3]], g[2],
            ST._chunk_bytes(g[2].depth, hard=False)))[0] for g in gs]
        ss.join()
        return outs
    run(groups)
    span, _ = _events_ms(lambda: run(groups))
    block_spans = []
    for b in range(len(pres)):
        gs = [(n, k, g, [m for m in ms if m[0] == b])
              for n, k, g, ms in groups]
        gs = [g for g in gs if g[3]]
        block_spans.append(_events_ms(lambda: run(gs))[0])
    prefix = f"the first {n_steps} steps of each block, W = 1024"
    out = {"blocks": len(pres), "groups": len(groups),
           "lane_encode_blocks": {
               "ms": e_ms, "one_launch_a_block_sum_ms": e_one,
               "bytes": e_bytes,
               "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3,
               "bit_steps_per_block": steps,
               "plain_ms": plain["lane_encode_blocks"],
               "prefix_ms": prefix_ms["lane_encode_blocks"],
               "plain_shape": prefix},
           "lane_decode_blocks": {
               "ms": d_ms, "one_launch_a_block_sum_ms": d_one,
               "bound_ms": steps * bar_us / 1e3, "bound_by": "latency",
               "plain_ms": plain["lane_decode_blocks"],
               "prefix_ms": prefix_ms["lane_decode_blocks"],
               "plain_shape": prefix},
           "compact_window": {
               "streams": len(streams),
               "device_ms": _device_ms(lambda: CC.compact_streams_dev(
                   streams, tails), 20, C_KERNEL),
               "wrapper_ms": _time_ms(lambda: CC.compact_streams_dev(
                   streams, tails), 20),
               "plain_ms": _time_ms(lambda: CC.compact_streams_plain(
                   streams, tails), 3),
               "bytes": c_bytes,
               "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3},
           "coder_span": {"window_ms": span, "block_spans_ms": block_spans,
                          "sum_ms": sum(block_spans)}}
    print(json.dumps({"window_kernels": out}), flush=True)
    return out


def window_path(data: bytes, level: int) -> tuple:
    """The 16k window path at `level` through api.encode_fastq /
    decode_fastq (4 blocks of 16,384 records, one window by default),
    the launch counts set to 0 just before and read just after: the
    container's size and SHA-256 equal the JAX package's, the round trip
    is exact, Kernel C runs once for the window and E and D once per
    stream group, each launch over several blocks (at level 4 a block
    takes a match trial). Returns (launches, descriptors) by kernel."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.models import matcher as M
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    _cuda.reset_launches()
    enc = api.encode_fastq(data, level=level, device="cuda",
                           block_records=WINDOW_RECORDS)
    dec = api.decode_fastq(enc, device="cuda")
    launches, descs = dict(_cuda.launches), dict(_cuda.descs)
    nbytes, want_sha = PINNED_16K[level]
    sha = hashlib.sha256(enc).hexdigest()
    if (len(enc), sha) != (nbytes, want_sha):
        raise AssertionError(f"16k L{level} container {len(enc)} bytes, "
                             f"SHA-256 {sha}: not the JAX package's")
    if dec != data:
        raise AssertionError(f"16k L{level} decode does not return the "
                             "input")
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
    if level == 3:
        # BASELINE.md's 16k L3 ratio is bench.py's: one block of
        # synth_fastq(16384) (a smaller genome than the 4-block set's)
        one = _pinned(WINDOW_RECORDS)
        ratio = len(one) / len(api.encode_fastq(
            one, level=3, device="cuda", block_records=WINDOW_RECORDS))
        if round(ratio, 4) != 6.2698:
            raise AssertionError(f"one 16k block's L3 ratio {ratio}")
    if level == 4 and not any(fl & MATCH_USED for fl in flags):
        raise AssertionError(f"16k L4 block flags {flags}: no MATCH_USED")
    # one E a stream name (7, and at level 4 each threshold's SEQ@t and
    # MATCH@t); D: the 5 aux streams, QUAL and SEQ, at level 4 MATCH and
    # SEQ's match-family launch; C once over the window's 28 or more
    # streams
    e_max, d_max = (7, 7) if level == 3 else (7 + 2 * len(M.THRESHOLDS), 9)
    if launches["compact_lanes_dev"] != 1 \
            or descs["compact_lanes_dev"] < 4 * 7 \
            or launches["lane_encode"] > e_max \
            or launches["lane_decode"] > d_max \
            or any(descs[k] <= launches[k]
                   for k in ("lane_encode", "lane_decode")):
        raise AssertionError(f"16k L{level} window launches {launches}, "
                             f"descriptors {descs}")
    print(f"window path L{level}: 4 x {WINDOW_RECORDS} records, {len(data)} "
          f"raw -> {len(enc)} bytes (ratio {len(data) / len(enc):.4f}), "
          f"SHA-256 equals the JAX package's, block flags {flags}, round "
          f"trip exact, launches {launches} (descriptors {descs})",
          flush=True)
    return launches, descs


def _walls(data: bytes, level: int, block_records: int, window) -> tuple:
    import torch
    from slimfastq_tpu_torch import api
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=level, device="cuda",
                           block_records=block_records, window=window)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device="cuda", window=window)
    t_dec = time.perf_counter() - t
    if dec != data:
        raise AssertionError(f"window {window}: round trip is not exact")
    return t_enc, t_dec, hashlib.sha256(enc).hexdigest()


def window_walls(data: bytes) -> dict:
    """Encode and decode walls of the 4 16k blocks with the window on (4)
    and one block at a time, at level 3 and level 4, in turns."""
    out = {}
    for level in (3, 4):
        runs = {4: [], 1: []}
        for window in (4, 1, 1, 4):
            t_enc, t_dec, sha = _walls(data, level, WINDOW_RECORDS, window)
            if sha != PINNED_16K[level][1]:
                raise AssertionError(f"window {window}: SHA-256 differs")
            runs[window].append((t_enc, t_dec))
        out[f"L{level}"] = {f"window_{w}": {"encode_s": [r[0] for r in v],
                                             "decode_s": [r[1] for r in v]}
                            for w, v in runs.items()}
    print(json.dumps({"window_walls": out}), flush=True)
    return out


def window_sweep(data4: bytes) -> dict:
    """Walls by window, each window once: level 3 with {1, 2, 4, 8} on 8
    blocks of 16,384 records (the first 131,072 records of the 4-block
    set), and on the 4-block set of 65,536-record blocks {1, 2, 4} at
    level 3 and {1, 4} at level 4. The bytes never depend on the
    window."""
    import numpy as np
    nl = np.flatnonzero(np.frombuffer(data4, dtype=np.uint8) == 10)
    data16 = data4[: int(nl[4 * 8 * WINDOW_RECORDS - 1]) + 1]
    out = {}
    for data, records, level, windows in (
            (data16, WINDOW_RECORDS, 3, (1, 2, 4, 8)),
            (data4, READS, 3, (1, 2, 4)),
            (data4, READS, 4, (1, 4))):
        runs, shas = {}, set()
        for w in windows:
            t_enc, t_dec, sha = _walls(data, level, records, w)
            runs[w] = {"encode_s": t_enc, "decode_s": t_dec}
            shas.add(sha)
        if len(shas) != 1:
            raise AssertionError(f"{records}-record blocks: the bytes depend "
                                 "on the window")
        blocks = (data.count(b"\n") // 4 + records - 1) // records
        out[f"L{level} {records}x{blocks}"] = runs
    print(json.dumps({"window_sweep": out}), flush=True)
    return out


def _peak_rss_mb(fn):
    """(fn(), the process's peak resident memory in MB while fn ran,
    sampled every 2 ms from /proc/self/statm by a watcher thread)."""
    import os
    import threading
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    peak, done = [rss()], threading.Event()

    def watch():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            done.wait(0.002)
    t = threading.Thread(target=watch)
    t.start()
    try:
        out = fn()
    finally:
        done.set()
        t.join()
    return out, max(peak[0], rss()) / 1e6


def _streaming_child(d: str) -> int:
    """`chip_smoke.py --streaming-child DIR`, a fresh process: DIR/in.fq
    through api.encode_file_streaming (chunks that cut records) into
    DIR/out.sfq, then that output cut mid-way through its third block and
    resumed (it must come back the same), then decode_file_streaming into
    DIR/back.fq; prints one JSON line with the process's resident memory
    once the card is up and its peak during each phase."""
    import io
    import os
    import torch
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    torch.zeros(1, device="cuda")
    _cuda.build()
    src, dst, back = (os.path.join(d, n) for n in ("in.fq", "out.sfq",
                                                    "back.fq"))
    kw = dict(level=3, device="cuda", block_records=WINDOW_RECORDS,
              chunk_bytes=STREAM_CHUNK)
    out = {"base_rss_mb": _peak_rss_mb(lambda: None)[1]}
    _, out["encode_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.encode_file_streaming(src, dst, **kw))
    with open(dst, "rb") as f:
        full = f.read()
    offs = container.read_index(io.BytesIO(full))
    with open(dst, "wb") as f:
        f.write(full[: offs[2] + 1000])
    _, out["resume_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.encode_file_streaming(src, dst, resume=True, **kw))
    with open(dst, "rb") as f:
        if f.read() != full:
            raise AssertionError("the resumed container differs")
    _, out["decode_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.decode_file_streaming(dst, back, device="cuda"))
    print(json.dumps(out), flush=True)
    return 0


def streaming(data: bytes) -> dict:
    """The 4 16k blocks through the streaming path in a fresh process
    (_streaming_child, so its memory is its own): the streamed container
    equals encode_fastq's (the pinned SHA-256), the resumed copy equals
    it, and the streaming decode gives the input back."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.fq"), "wb") as f:
            f.write(data)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--streaming-child", d], capture_output=True,
                           text=True, timeout=300)
        if r.returncode:
            raise AssertionError(f"streaming phase failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(d, "out.sfq"), "rb") as f:
            full = f.read()
        if hashlib.sha256(full).hexdigest() != PINNED_16K[3][1]:
            raise AssertionError("streaming encode differs from "
                                 "encode_fastq's container")
        with open(os.path.join(d, "back.fq"), "rb") as f:
            if f.read() != data:
                raise AssertionError("streaming decode does not return the "
                                     "input")
    out.update(chunk_bytes=STREAM_CHUNK, raw_bytes=len(data),
               compressed_bytes=len(full))
    print(json.dumps({"streaming": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6: long reads, the host-pack path
# ---------------------------------------------------------------------------

def _long_read_kernels(pre, enc: bytes, dev, bar_us: float,
                       errs: dict) -> dict:
    """Kernels E, D and C on the long block's QUAL stream, from the main
    path's own setup (pipeline_native.prepare_block_fast packs it on the
    host; _sq_jobs gives its Slices): E over its step slices (CUDA events
    around the slices with their schedules, less the schedules alone),
    D once on the container's QUAL payload (events; its symbols held
    against the host-packed ones), C on E's chunk buffers (events around
    its wrapper); each beside its bound. E and its plain version over the
    stream's first 2 chunks in 2 slices (`errs`)."""
    import io
    import numpy as np
    import torch
    from slimfastq_tpu_torch import container
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(3)
    q = next(PN._sq_jobs(pre, cfg, dev, only=("QUAL",)))
    sl = q.idx_c
    if not isinstance(sl, ST.Slices):
        raise AssertionError("the long block's QUAL is not sliced")
    W, NC, depth = cfg.lanes, sl.NC, q.geom.depth
    step = ST.slice_chunks(depth, W)
    CB = ST._chunk_bytes(depth, hard=False)
    out = {"W": W, "NC": NC, "depth": depth, "slices": -(-NC // step),
           "bit_steps": NC * 8 * depth}
    # E and its plain version over the first 2 chunks, 1 chunk a slice
    head = ST.Slices(sl.kind, sl.geom, sl.syms[:16], sl.pos[:16],
                     sl.reset[:16], sl.counts, None)
    t = time.perf_counter()
    carry = CT.EncCarry()
    plain = (torch.zeros((2, W, CB), dtype=torch.uint8, device=dev),
             torch.zeros((2, W), dtype=torch.int32, device=dev))
    for c in (0, 1):
        (_, _, low, emax), = CT.lane_encode_blocks_plain(
            [head(c, c + 1)], q.geom, CB, [carry],
            [(plain[0][c:c + 1], plain[1][c:c + 1])])
    out["plain_ms_2_chunks"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_encode_sliced", "sliced E vs plain, long QUAL",
             CT.lane_encode_sliced(head, 2, 1, W, q.geom, CB, dev),
             (*plain, low, emax))
    def schedules():
        for c0 in range(0, NC, step):
            sl(c0, min(NC, c0 + step))
    sched_ms, _ = _events_ms(schedules)
    total_ms, (ebufs, eptrs, low, emax) = _events_ms(
        lambda: CT.lane_encode_sliced(sl, NC, step, W, q.geom, CB, dev))
    if int(emax) > CB:
        raise AssertionError("long QUAL: optimistic chunk buffer overflowed")
    e_bytes = 2 * NC * 8 * depth * W * 4 + ebufs.numel() + eptrs.numel() * 4 \
        + 2 * W * 4
    out["lane_encode"] = {
        "ms": total_ms - sched_ms, "with_schedules_ms": total_ms,
        "schedules_ms": sched_ms, "bytes": e_bytes,
        "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "lockstep_ms": NC * 8 * depth * bar_us / 1e3}
    Bmax = int(eptrs.sum(dim=0).max())
    streams = [(ebufs, eptrs, Bmax)]
    c_bytes = _c_bytes(streams)
    # CUDA events around the wrapper: the profiler kept no record of C
    # after E's long run in one call on the H100
    out["compact_lanes_dev"] = {
        "ms": _time_ms(lambda: CC.compact_streams_dev(streams), 3),
        "timed": "CUDA events around the wrapper",
        "bytes": c_bytes, "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "NC": NC, "Bmax": Bmax}
    del ebufs, eptrs, streams, sl, q
    f = io.BytesIO(enc)
    blk = next(container.iter_blocks(f, container.read_header(f)))
    qs = blk.streams["QUAL"]
    ll_mat, counts = pre[4], pre[0]["QUAL"][3]
    S = int(counts.max())
    Sp, pos, reset = ST._ll_inputs(ll_mat, S, W, dev)
    item = (ST._payload_tensor(qs.payload, dev),
            ST._to(qs.lane_lens, dev, torch.int32),
            ST._acts(ST._to(counts, dev, torch.int32), Sp), pos, reset)
    d_ms, (syms,) = _events_ms(lambda: CT.lane_decode_blocks(
        [item], "qual", pre[0]["QUAL"][1]))
    if not np.array_equal(syms[:S].cpu().numpy(), pre[0]["QUAL"][2]):
        raise AssertionError("D on the long QUAL does not return its "
                             "host-packed symbols")
    steps = NC * 8 * depth
    out["lane_decode"] = {
        "ms": d_ms, "bound_ms": steps * bar_us / 1e3, "bound_by": "latency",
        "byte_bound_ms": (qs.payload.size + 3 * Sp * W * 4 + Sp * W)
        / HBM_BYTES_PER_S * 1e3, "us_per_bit_step": d_ms * 1e3 / steps}
    out["lane_encode"]["us_per_bit_step"] = \
        out["lane_encode"]["ms"] * 1e3 / steps
    return out


def long_read(dev, bar_us: float, errs: dict) -> dict:
    """One block of 65,536 x 16.5 kb reads (LONG_READS x LONG_LEN: raw
    span >= 2 GiB, so SEQ and QUAL pack on the host) through
    api.encode_fastq / decode_fastq at the defaults (level 3, 65,536
    records a block) on the card, the launch counts set to 0 just before
    each direction and read just after: the round trip is exact, Kernel E
    ran in more than one step slice, D and C ran. Prints the `long_read`
    line: walls and GB/s, the ratio, peak device memory each way, E's
    slices and launches, D's and C's launches, the block's device bytes
    against the window budget; then the long QUAL's kernels
    (_long_read_kernels)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    t = time.perf_counter()
    data = synth_fastq(LONG_READS, read_len=LONG_LEN, seed=0, var_len=False,
                       n_rate=0.0005)
    out = {"make_data_s": time.perf_counter() - t, "raw_bytes": len(data)}
    idx, n = native.fastq_index(data)
    out["span"] = PN.block_span(idx, 0, n)
    if out["span"] < 1 << 31:
        raise AssertionError(f"long block spans {out['span']} < 2^31 bytes")
    # the block as the main path prepares it (host prep timed), its device
    # bytes against the window budget: a second such block would take a
    # window of its own
    t = time.perf_counter()
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, config_for_level(3))
    out["host_prep_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    budget = ST.device_budget(dev)
    need = PN.device_bytes(pre, config_for_level(3))
    out.update(device_budget=budget, block_device_bytes=need,
               windows_of_two_such_blocks=ST.split_by_bytes([need, need],
                                                            budget))
    for way in ("encode", "decode"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t = time.perf_counter()
        if way == "encode":
            enc = api.encode_fastq(data, device="cuda")
        else:
            dec = api.decode_fastq(enc, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        out[way] = {"wall_s": wall_s, "GB_per_s": len(data) / wall_s / 1e9,
                    "peak_device_GB": torch.cuda.max_memory_allocated()
                    / 1e9, "launches": dict(_cuda.launches),
                    "descriptors": dict(_cuda.descs),
                    "slices": dict(_cuda.slices)}
    if dec != data:
        raise AssertionError("long block: the round trip is not exact")
    del dec
    e, d = out["encode"], out["decode"]
    if e["slices"]["lane_encode"] < 2 or e["launches"]["lane_encode"] < 3 \
            or e["launches"]["compact_lanes_dev"] < 1 \
            or d["launches"]["lane_decode"] < 2:
        raise AssertionError(f"long block launches: encode {e}, decode {d}")
    out["ratio"] = len(data) / len(enc)
    out["compressed_bytes"] = len(enc)
    print(json.dumps({"long_read": out}), flush=True)
    del data
    out["kernels"] = _long_read_kernels(pre, enc, dev, bar_us, errs)
    print(json.dumps({"long_read_kernels": out["kernels"]}), flush=True)
    return out


def host_pack_pins(data: bytes, dev, errs: dict) -> None:
    """The pinned 64k block through the host-pack path (the port's
    _MAX_SPAN lowered to 1, step slices of 40 QUAL chunks): its container
    keeps the JAX package's SHA-256 at level 3 and at level 4
    (MATCH_USED) and decodes exactly through the host unpack; and the
    pinned QUAL stream in step slices of 37 chunks gives the one launch's
    bytes (`errs`)."""
    import io
    import numpy as np
    from slimfastq_tpu_torch import api, container, native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    saved = PN._MAX_SPAN, ST.SLICE_BYTES
    PN._MAX_SPAN, ST.SLICE_BYTES = 1, 40 * 2 * 4 * 8 * 6 * 1024
    try:
        for level in (3, 4):
            _cuda.reset_launches()
            enc = api.encode_fastq(data, level=level, device="cuda")
            slices = _cuda.slices["lane_encode"]
            sha = hashlib.sha256(enc).hexdigest()
            if (len(enc), sha) != PINNED[level] or slices < 2:
                raise AssertionError(f"host-pack L{level}: {len(enc)} bytes, "
                                     f"SHA-256 {sha}, {slices} E slices")
            f = io.BytesIO(enc)
            flags = next(container.iter_blocks(f, container.read_header(
                f))).flags
            if level == 4 and not flags & MATCH_USED:
                raise AssertionError("host-pack L4: no MATCH_USED")
            if api.decode_fastq(enc, device="cuda") != data:
                raise AssertionError(f"host-pack L{level}: the round trip "
                                     "is not exact")
            print(f"host-pack path L{level}: the pinned block's SHA-256, "
                  f"{slices} E slices, flags {flags}, round trip exact",
                  flush=True)
    finally:
        PN._MAX_SPAN, ST.SLICE_BYTES = saved
    cfg = config_for_level(3)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    q = next(PN._sq_jobs(pre, cfg, dev, only=("QUAL",)))
    CB = ST._chunk_bytes(q.geom.depth, hard=False)
    sl = ST.Slices(q.kind, q.geom, q.syms, q.pos, q.reset, q.counts, None)
    _compare(errs, "lane_encode_sliced", "pinned QUAL: E in slices of 37 "
             "chunks vs one launch",
             CT.lane_encode_sliced(sl, sl.NC, 37, 1024, q.geom, CB, dev),
             CT.lane_encode(q.idx_c, q.bit_c, q.geom, CB))
    print("pinned QUAL: E in 22 slices equals one launch", flush=True)


# ---------------------------------------------------------------------------
# phase 7: block sharding over the node's cards, the gather, L1 slices
# ---------------------------------------------------------------------------

def _sharded_walls(data: bytes, level: int, mesh) -> tuple:
    """(encode s, decode s, container, launches by shard) of `data`
    through the sharded path on `mesh`, or through api.encode_fastq /
    decode_fastq with mesh=None; the launch counts set to 0 just before
    and read just after."""
    import torch
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import sharded as SH
    cfg = config_for_level(level)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    enc = (api.encode_fastq(data, cfg=cfg, device="cuda") if mesh is None
           else SH.encode_fastq_sharded(data, cfg, mesh=mesh))
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = (api.decode_fastq(enc, device="cuda") if mesh is None
           else SH.decode_fastq_sharded(enc, mesh=mesh))
    t_dec = time.perf_counter() - t
    by_shard = {f"shard {i} on {d}": dict(v)
                for (i, d), v in sorted(_cuda.by_shard.items())}
    if dec != data:
        raise AssertionError(f"sharded L{level}: the round trip is not exact")
    if mesh is not None:
        kinds = {"lane_encode", "lane_decode", "compact_lanes_dev"}
        if len(by_shard) != min(mesh.size, data.count(b"\n") // 4 // READS
                                or 1) \
                or any(set(v) != kinds for v in by_shard.values()):
            raise AssertionError(f"sharded L{level} on {mesh.size} shards: "
                                 f"launches by shard {by_shard}")
    return t_enc, t_dec, enc, by_shard


def sharded(data: bytes, data4: bytes) -> dict:
    """The sharded path (parallel.sharded.encode_fastq_sharded /
    decode_fastq_sharded) on make_mesh() (every card) and on a mesh
    naming cuda:0 twice (two shard threads on one card): the pinned block
    keeps both SHA-256 pins; the 4 x 64k set at level 3 and 4 gives
    api.encode_fastq's container, with the walls of the single card, the
    mesh and the card twice in turns (single, mesh, twice, twice, mesh,
    single; after one untimed pass on each mesh, the first use of its
    cards) and each shard's launches. Returns (the `sharded` line, the
    4 x 64k set's level-3 container)."""
    from slimfastq_tpu_torch.parallel import mesh as M
    meshes = {"make_mesh": M.make_mesh(),
              "card_twice": M.make_mesh(devices=["cuda:0", "cuda:0"])}
    out = {"mesh_sizes": {k: m.size for k, m in meshes.items()}}
    wants = {}
    for mesh in meshes.values():  # every card's first use, untimed
        _sharded_walls(data4, 3, mesh)
    for level in (3, 4):
        for name, mesh in meshes.items():
            _, _, enc, _ = _sharded_walls(data, level, mesh)
            sha = hashlib.sha256(enc).hexdigest()
            if (len(enc), sha) != PINNED[level]:
                raise AssertionError(f"sharded L{level} on {name}: the "
                                     f"pinned block gives {len(enc)} bytes, "
                                     f"SHA-256 {sha}")
        runs = {"single": [], "make_mesh": [], "card_twice": []}
        want = None
        for name in ("single", "make_mesh", "card_twice", "card_twice",
                     "make_mesh", "single"):
            t_enc, t_dec, enc, by_shard = _sharded_walls(
                data4, level, meshes.get(name))
            want = want or enc
            if enc != want:
                raise AssertionError(f"sharded L{level} on {name}: the "
                                     "container differs from api's")
            runs[name].append({"encode_s": t_enc, "decode_s": t_dec,
                               "launches_by_shard": by_shard})
        out[f"L{level}"] = {"raw_bytes": len(data4),
                            "compressed_bytes": len(want), **runs}
        wants[level] = want
    print(json.dumps({"sharded": out}), flush=True)
    return out, wants[3]


def sharded_streaming(data: bytes) -> dict:
    """The 16k set through encode_file_streaming_sharded on the card named
    twice (chunks that cut records), a copy cut in its third block and
    resumed, and decode_file_streaming_sharded: the pinned 16k container
    (its SHA-256) and the input back; the launch counts set to 0 just
    before and read just after."""
    import io
    import os
    import tempfile
    from slimfastq_tpu_torch import container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import mesh as M
    from slimfastq_tpu_torch.parallel import sharded as SH
    mesh = M.make_mesh(devices=["cuda:0", "cuda:0"])
    kw = dict(level=3, mesh=mesh, block_records=WINDOW_RECORDS,
              chunk_bytes=STREAM_CHUNK)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        src, dst, back = (os.path.join(d, n) for n in ("in.fq", "o.sfq",
                                                        "b.fq"))
        with open(src, "wb") as f:
            f.write(data)
        _cuda.reset_launches()
        t = time.perf_counter()
        SH.encode_file_streaming_sharded(src, dst, **kw)
        out["encode_s"] = time.perf_counter() - t
        out["launches_by_shard"] = {f"shard {i} on {dv}": dict(v) for
                                    (i, dv), v in _cuda.by_shard.items()}
        with open(dst, "rb") as f:
            full = f.read()
        if hashlib.sha256(full).hexdigest() != PINNED_16K[3][1]:
            raise AssertionError("sharded streaming encode differs from the "
                                 "pinned 16k container")
        if len(out["launches_by_shard"]) != 2:
            raise AssertionError(f"sharded streaming: launches by shard "
                                 f"{out['launches_by_shard']}")
        offs = container.read_index(io.BytesIO(full))
        with open(dst, "wb") as f:
            f.write(full[: offs[2] + 1000])
        t = time.perf_counter()
        SH.encode_file_streaming_sharded(src, dst, resume=True, **kw)
        out["resume_s"] = time.perf_counter() - t
        with open(dst, "rb") as f:
            if f.read() != full:
                raise AssertionError("sharded streaming: the resumed "
                                     "container differs")
        t = time.perf_counter()
        SH.decode_file_streaming_sharded(dst, back, mesh=mesh)
        out["decode_s"] = time.perf_counter() - t
        with open(back, "rb") as f:
            if f.read() != data:
                raise AssertionError("sharded streaming decode does not "
                                     "return the input")
    print(json.dumps({"sharded_streaming": out}), flush=True)
    return out


def _gather_child(d: str) -> int:
    """`chip_smoke.py --gather-child DIR`, a fresh process: a process
    group of world size 1 on NCCL over a localhost TCP store
    (parallel.multihost.initialize); each DIR/shard{i}.sfq through
    parallel.gather.ragged_all_gather (timed, host clock around the call,
    which synchronises), merged (multihost.merge_containers) into
    DIR/merged.sfq; the group destroyed after. Prints one JSON line."""
    import glob
    import os
    import socket
    import torch
    import torch.distributed as dist
    from slimfastq_tpu_torch.parallel import gather, multihost
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the process group is not on NCCL")
        shards = []
        for p in sorted(glob.glob(os.path.join(d, "shard*.sfq"))):
            with open(p, "rb") as f:
                shards.append(f.read())
        gather.ragged_all_gather(shards[0])  # warm-up: NCCL's first call
        parts, ms = [], []
        for sb in shards:
            torch.cuda.synchronize()
            t = time.perf_counter()
            parts += gather.ragged_all_gather(sb, return_parts=True)
            ms.append((time.perf_counter() - t) * 1e3)
        with open(os.path.join(d, "merged.sfq"), "wb") as f:
            f.write(multihost.merge_containers([q.tobytes() for q in parts]))
    finally:
        dist.destroy_process_group()
    # the least time of a call: the padded row up to the card and each
    # part down over the host link, the all_gather's copy (world size 1:
    # one row read and written) at the card's memory rate
    link = [2 * len(sb) for sb in shards]
    copy = [2 * len(sb) for sb in shards]
    bound = [a / PCIE_BYTES_PER_S * 1e3 + b / HBM_BYTES_PER_S * 1e3
             for a, b in zip(link, copy)]
    print(json.dumps({"world_size": 1, "backend": "nccl",
                      "shard_bytes": [len(sb) for sb in shards],
                      "gather_ms": ms, "bound_ms": bound,
                      "bound_by": "bytes",
                      "bound_rates": {"host_link_bytes_per_s":
                                      PCIE_BYTES_PER_S,
                                      "hbm_bytes_per_s": HBM_BYTES_PER_S}}),
          flush=True)
    return 0


def gather_nccl(data4: bytes, whole: bytes) -> dict:
    """ragged_all_gather over NCCL (world size 1, in a fresh process:
    _gather_child): the 4 x 64k set cut into 4 process shards
    (multihost.process_block_ranges), each shard's container gathered and
    merged: the whole container `whole`."""
    import os
    import tempfile
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch.parallel import multihost
    idx, n = native.fastq_index(data4)
    with tempfile.TemporaryDirectory() as d:
        for p in range(WALL_BLOCKS):
            (lo, hi), = multihost.process_block_ranges(n, READS, WALL_BLOCKS,
                                                       p)
            start = int(idx["id_off"][lo]) - 1
            end = int(idx["id_off"][hi]) - 1 if hi < n else len(data4)
            with open(os.path.join(d, f"shard{p}.sfq"), "wb") as f:
                f.write(api.encode_fastq(data4[start:end], level=3,
                                         device="cuda"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--gather-child", d], capture_output=True,
                           text=True, timeout=240)
        if r.returncode:
            raise AssertionError(f"gather_nccl phase failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(d, "merged.sfq"), "rb") as f:
            if f.read() != whole:
                raise AssertionError("gathered shards merge into another "
                                     "container than the whole encode's")
    print(json.dumps({"gather_nccl": out}), flush=True)
    return out


def l1_slices(data: bytes, dev, errs: dict) -> dict:
    """Level 1, whose SEQ and QUAL tables live in shared memory: the
    pinned block forced through the host-pack path with SLICE_BYTES
    lowered (SEQ and QUAL both in step slices, 20 + 7 or more) equals the
    unforced L1 container and round-trips, the launch counts set to 0
    just before and read just after; its QUAL in slices of 37 chunks
    equals one launch, and E over the first 2 chunks in 2 slices equals
    its plain version (`errs`)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(1)
    if not (CT.table_in_smem(cfg.qual, 1024)
            and CT.table_in_smem(cfg.seq, 1024)):
        raise AssertionError("L1 tables do not live in shared memory")
    want = api.encode_fastq(data, cfg=cfg, device="cuda")
    saved = PN._MAX_SPAN, ST.SLICE_BYTES, CT.lane_encode_slices
    kinds = []

    def spy(build, *args):
        kinds.append(build.kind)
        return saved[2](build, *args)
    PN._MAX_SPAN, ST.SLICE_BYTES = 1, 40 * 2 * 4 * 8 * 6 * 1024
    CT.lane_encode_slices = spy
    try:
        _cuda.reset_launches()
        enc = api.encode_fastq(data, cfg=cfg, device="cuda")
        slices = _cuda.slices["lane_encode"]
        if enc != want or sorted(set(kinds)) != ["qual", "seq"] \
                or slices < 20 + 7:
            raise AssertionError(f"host-pack L1: {len(enc)} bytes (the "
                                 f"unforced {len(want)}), {slices} E slices "
                                 f"of {kinds}")
        if api.decode_fastq(enc, device="cuda") != data:
            raise AssertionError("host-pack L1: the round trip is not exact")
    finally:
        PN._MAX_SPAN, ST.SLICE_BYTES, CT.lane_encode_slices = saved
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    q = next(PN._sq_jobs(pre, cfg, dev, only=("QUAL",)))
    CB = ST._chunk_bytes(q.geom.depth, hard=False)
    sl = ST.Slices(q.kind, q.geom, q.syms, q.pos, q.reset, q.counts, None)
    one_ms, one = _events_ms(lambda: CT.lane_encode(q.idx_c, q.bit_c, q.geom,
                                                    CB))
    sliced_ms, got = _events_ms(lambda: CT.lane_encode_sliced(
        sl, sl.NC, 37, 1024, q.geom, CB, dev))
    _compare(errs, "lane_encode_sliced", "L1 QUAL: E in slices of 37 chunks "
             "(a shared-memory table) vs one launch", got, one)
    part = ST.Slices(q.kind, q.geom, q.syms[:16], q.pos[:16], q.reset[:16],
                     q.counts, None)
    k = CT.lane_encode_sliced(part, 2, 1, 1024, q.geom, CB, dev)
    carry = CT.EncCarry()
    p_out = (torch.zeros((2, 1024, CB), dtype=torch.uint8),
             torch.zeros((2, 1024), dtype=torch.int32))
    for c0 in (0, 1):
        (_, _, low, emax), = CT.lane_encode_blocks_plain(
            [tuple(x.cpu() for x in part(c0, c0 + 1))], q.geom, CB, [carry],
            [(p_out[0][c0:c0 + 1], p_out[1][c0:c0 + 1])])
    _compare(errs, "lane_encode_sliced", "L1 QUAL: E over 2 chunks in 2 "
             "slices vs its plain version", [x.cpu() for x in k],
             (*p_out, low, emax))
    out = {"unforced_bytes": len(want), "forced_slices": slices,
           "qual_one_launch_ms": one_ms, "qual_37_chunk_slices_ms": sliced_ms,
           "qual_NC": sl.NC, "table_bytes": CT.table_bytes(q.geom)}
    print(json.dumps({"l1_slices": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the host-side reference paths
# ---------------------------------------------------------------------------

# launches a direction of the pinned block through the pure-Python
# pipeline, by level: every stream its own E and C (level 4: the plain SEQ
# and both trials' SEQ and MATCH), D once a stream (level 4: MATCH too)
PYTHON_LAUNCHES = {
    3: ({"lane_encode": 7, "lane_decode": 0, "compact_lanes_dev": 7},
        {"lane_encode": 0, "lane_decode": 7, "compact_lanes_dev": 0}),
    4: ({"lane_encode": 11, "lane_decode": 0, "compact_lanes_dev": 11},
        {"lane_encode": 0, "lane_decode": 8, "compact_lanes_dev": 0}),
}


def _profiled(fn) -> tuple:
    """(fn(), {host wall ms, device busy ms (the union of the device
    intervals), device ms summed, launches}) of one run under
    torch.profiler, the launch counts set to 0 just before and read just
    after."""
    from slimfastq_tpu_torch.ops import _cuda
    from tools.gpu_profile import _profile
    _cuda.reset_launches()
    out, rep = _profile(fn)
    return out, {"host_ms": rep["wall_s"] * 1e3,
                 "device_busy_ms": rep["device_busy_s"] * 1e3,
                 "device_sum_ms": rep["device_sum_s"] * 1e3,
                 "launches": dict(_cuda.launches)}


def python_pipeline(data: bytes) -> dict:
    """The pinned block through the pure-Python pipeline on the card
    (use_native=False) at level 3 and 4, and at level 3 through the
    sharded path on make_mesh(): both SHA-256 pins, exact round trips,
    the launches of each direction as PYTHON_LAUNCHES says, level 4's
    MATCH_USED; then the NumPy oracle (backend="oracle") against the card
    on a 2,048-read input, with no launch and no device allocation."""
    import io
    import torch
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import mesh as M
    from slimfastq_tpu_torch.parallel import sharded as SH
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    out = {}
    for level in (3, 4):
        enc, e = _profiled(lambda: api.encode_fastq(
            data, level=level, device="cuda", use_native=False))
        dec, d = _profiled(lambda: api.decode_fastq(
            enc, device="cuda", use_native=False))
        if (len(enc), hashlib.sha256(enc).hexdigest()) != PINNED[level]:
            raise AssertionError(f"use_native=False L{level}: the pinned "
                                 f"block gives {len(enc)} bytes")
        if dec != data:
            raise AssertionError(f"use_native=False L{level}: the round "
                                 "trip is not exact")
        f = io.BytesIO(enc)
        cfg = container.read_header(f)
        flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
        if level == 4 and not flags[0] & MATCH_USED:
            raise AssertionError(f"use_native=False L4: flags {flags}")
        want_e, want_d = PYTHON_LAUNCHES[level]
        if (e["launches"], d["launches"]) != (want_e, want_d):
            raise AssertionError(f"use_native=False L{level}: launches "
                                 f"{e['launches']} / {d['launches']}")
        out[f"L{level}"] = {"encode": e, "decode": d, "flags": flags}
    mesh = M.make_mesh()
    enc, e = _profiled(lambda: SH.encode_fastq_sharded(
        data, config_for_level(3), mesh=mesh, use_native=False))
    dec, d = _profiled(lambda: SH.decode_fastq_sharded(
        enc, mesh=mesh, use_native=False))
    if (len(enc), hashlib.sha256(enc).hexdigest()) != PINNED[3] \
            or dec != data:
        raise AssertionError("use_native=False on make_mesh(): not the "
                             "single card's container or round trip")
    if not all(e["launches"][k] for k in ("lane_encode",
                                          "compact_lanes_dev")) \
            or not d["launches"]["lane_decode"]:
        raise AssertionError(f"use_native=False on make_mesh(): launches "
                             f"{e['launches']} / {d['launches']}")
    out["L3_make_mesh"] = {"mesh_size": mesh.size, "encode": e,
                           "decode": d}
    small = _pinned(ORACLE_READS)
    card = api.encode_fastq(small, level=3, device="cuda")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    t = time.perf_counter()
    enc = api.encode_fastq(small, level=3, backend="oracle")
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, backend="oracle")
    t_dec = time.perf_counter() - t
    untouched = (all(v == 0 for v in _cuda.launches.values()) and
                 torch.cuda.memory_stats().get("allocation.all.allocated",
                                               0) == allocs)
    if enc != card or dec != small or not untouched:
        raise AssertionError(f"oracle: container equal {enc == card}, "
                             f"round trip {dec == small}, card untouched "
                             f"{untouched}")
    out["oracle"] = {"reads": ORACLE_READS, "compressed_bytes": len(enc),
                     "encode_ms": t_enc * 1e3, "decode_ms": t_dec * 1e3,
                     "launches": dict(_cuda.launches),
                     "device_allocations": 0}
    print(json.dumps({"python_pipeline": out}), flush=True)
    return out


def single_stream_pack(data: bytes, dev) -> dict:
    """pack_device / unpack_device (ops/pack_torch, the JAX package's
    single-stream pack_jax.py:75 / :93, which no path runs) on the pinned
    block's QUAL (W = 1024): times by CUDA events beside each one's byte
    bound (pack: the QUAL bytes and the two [Rpl, W] int64 index matrices
    read, the [Sp, W] symbols written; unpack: the symbols and matrices
    read, the [pad_flat(total)] buffer written); the packed symbols equal
    pack_pair's QUAL and the unpack gives the QUAL bytes back."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.ops import pack_torch
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.pipeline_native import _BASE_TO_CODE_DEV
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    W = 1024
    lengths = idx["seq_len"].astype(np.int64)
    qoffs, soffs = idx["qual_off"].astype(np.int64), idx["seq_off"]
    minq, _ = native.minmax_ranges(buf, idx["qual_off"], lengths)
    Sp = pad_steps(int(np.bincount(np.arange(n) % W, weights=lengths,
                                   minlength=W).max()))
    dpad = np.zeros(pack_torch.pad_flat(len(buf)), dtype=np.uint8)
    dpad[: len(buf)] = buf
    d = torch.from_numpy(dpad).to(dev)
    syms = pack_torch.pack_device(d, qoffs, lengths, W, Sp, bias=minq)
    _, qual = pack_torch.pack_pair(d, soffs, qoffs, lengths, W, Sp,
                                   _BASE_TO_CODE_DEV, minq)
    counts = np.bincount(np.arange(n) % W, weights=lengths, minlength=W)
    active = torch.from_numpy(np.arange(Sp)[:, None] < counts[None, :]).to(
        dev)
    if not torch.equal(syms[active], qual[active]):
        raise AssertionError("pack_device differs from pack_pair's QUAL")
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    flat = pack_torch.unpack_device(syms, starts, lengths, W, total,
                                    bias=minq)
    want = np.concatenate([buf[o: o + L] for o, L in zip(qoffs, lengths)])
    if not np.array_equal(flat[:total].cpu().numpy(), want):
        raise AssertionError("unpack_device does not give QUAL back")
    Rpl = -(-n // W)
    mats = 2 * Rpl * W * 8
    pack_bytes = total + mats + Sp * W
    unpack_bytes = Sp * W + mats + pack_torch.pad_flat(total)
    out = {"shape": f"the pinned block's QUAL: n = {n}, W = {W}, "
                    f"Sp = {Sp}",
           "pack_ms": _time_ms(lambda: pack_torch.pack_device(
               d, qoffs, lengths, W, Sp, bias=minq), 20),
           "pack_bound_ms": pack_bytes / HBM_BYTES_PER_S * 1e3,
           "unpack_ms": _time_ms(lambda: pack_torch.unpack_device(
               syms, starts, lengths, W, total, bias=minq), 20),
           "unpack_bound_ms": unpack_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "pack_bytes": pack_bytes,
           "unpack_bytes": unpack_bytes}
    print(json.dumps({"single_stream_pack": out}), flush=True)
    return out


def _by_shard(shard: dict, name: str) -> dict:
    """Kernel `name`'s launches by shard in the level-3 sharded runs of
    the 4 x 64k set (the first run on each mesh)."""
    return {mesh: {k: v.get(name, 0) for k, v in
                   shard["L3"][mesh][0]["launches_by_shard"].items()}
            for mesh in ("make_mesh", "card_twice")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch.ops import _cuda
    from tools.compact_phase import phase
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")

    t = time.perf_counter()
    reports = _cuda.build()
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu ptxas: {line.strip()}", flush=True)

    # seconds each phase took, printed as the `phase_s` line
    phase_s, last = {}, [time.perf_counter()]

    def done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    plain, errs, plain4, errs4 = check_kernels(dev)
    check_ragged(dev, errs)
    done("kernels_vs_plain")
    check_windows(dev, errs)
    done("windows_vs_plain")
    data = _pinned(READS)
    data4 = _pinned(READS * WALL_BLOCKS)
    done("make_data")
    times = time_kernels(data, dev, errs)
    times4 = time_kernels_l4(data, dev, errs4)
    done("time_kernels")
    comp = block_compaction(data, dev, 3, errs)
    comp4 = block_compaction(data, dev, 4, errs4)
    phases = {}
    for level in (3, 4):
        phases[level] = phase(data, level, dev)
        print(json.dumps({f"compact_phase_l{level}": phases[level]}),
              flush=True)
    bar_us = barrier_us(dev)
    print(json.dumps({"barrier_us": bar_us}), flush=True)
    done("compaction_and_barrier")
    launches = main_path(data, 3)
    spans = block_spans(data, dev)
    wall(data4, dev, 3)
    done("main_path_l3")
    launches4 = main_path(data, 4)
    spans4 = l4_spans(data, dev)
    wall(data4, dev, 4)
    done("main_path_l4")
    # the small-block window path on the same 4-block set
    win = time_window(data, dev, bar_us, errs)
    done("window_kernels")
    wlaunches = {level: window_path(data, level) for level in (3, 4)}
    done("window_path")
    window_walls(data)
    done("window_walls")
    window_sweep(data4)
    done("window_sweep")
    streaming(data)
    done("streaming")
    # long reads: the host-pack path and Kernel E in step slices
    lr = long_read(dev, bar_us, errs)
    done("long_read")
    host_pack_pins(data, dev, errs)
    done("host_pack_pins")
    # block sharding, the NCCL gather, level 1's slices
    shard, whole = sharded(data, data4)
    done("sharded")
    sharded_streaming(data)
    done("sharded_streaming")
    gather_nccl(data4, whole)
    done("gather_nccl")
    l1 = l1_slices(data, dev, errs)
    done("l1_slices")
    # the host-side reference paths: the pure-Python pipeline on the card
    # and on make_mesh(), the NumPy oracle, the single-stream pack
    t = time.perf_counter()
    python_pipeline(data)
    print(json.dumps({"python_pipeline_s": time.perf_counter() - t}),
          flush=True)
    done("python_pipeline")
    single_stream_pack(data, dev)
    done("single_stream_pack")

    replaces = {
        "lane_encode": "slimfastq_tpu/ops/streams_jax.py:298",
        "lane_decode": "slimfastq_tpu/ops/streams_jax.py:450",
        "compact_lanes_dev": "slimfastq_tpu/ops/compact_pallas.py:40",
    }
    source = {"lane_encode": "slimfastq_tpu_torch/csrc/coder.cu",
              "lane_decode": "slimfastq_tpu_torch/csrc/coder.cu",
              "compact_lanes_dev": "slimfastq_tpu_torch/csrc/compact.cu"}
    shape = times["shape"]
    kernels = []
    for name in ("lane_encode", "lane_decode"):
        ms, nbytes = times[name]
        row = {
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "match": errs[name] == 0, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain[name],
            "plain_shape": "W=1024 Sp=256 qual",
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape}
        direction = "encode" if name == "lane_encode" else "decode"
        steps = times["bit_steps"]
        lockstep_ms = steps * bar_us / 1e3
        row.update({
            "bit_steps": steps, "us_per_bit_step": ms * 1e3 / steps,
            "barrier_us": bar_us,
            "block_streams_ms": spans[direction]["streams_ms"],
            "block_span_ms": spans[direction]["span_ms"],
            "block_sum_ms": spans[direction]["sum_ms"]})
        if name == "lane_encode":
            # E's table evolves with the schedule alone: the function
            # needs no barrier, so its bound stays the byte bound and
            # this design's barrier floor stands beside it
            row["lockstep_ms"] = lockstep_ms
        else:
            # D's law couples the lanes at every bit-step: one barrier
            # per bit-step is the floor of the function
            row.update({"bound_ms": lockstep_ms, "bound_by": "latency",
                        "byte_bound_ms": row["bound_ms"]})
        # level 4: the pinned block's SEQ stream (the winning match trial,
        # order-11 table); the checks of phase 3 at level 4
        ms4, nbytes4 = times4[name]
        steps4 = times4["bit_steps"]
        l4 = {"launches": launches4[name], "max_abs_err": errs4[name],
              "ms": ms4, "plain_ms": plain4[name],
              "plain_shape": "W=1024 Sp=256 seq, match family",
              "bound_ms": nbytes4 / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "shape": times4["shape"],
              "bit_steps": steps4, "us_per_bit_step": ms4 * 1e3 / steps4}
        if name == "lane_encode":
            l4.update({"lockstep_ms": steps4 * bar_us / 1e3,
                       "block_streams_ms": spans4["streams_ms"]})
        if name == "lane_decode":
            l4.update({"bound_ms": steps4 * bar_us / 1e3,
                       "bound_by": "latency",
                       "byte_bound_ms": l4["bound_ms"]})
        row["l4"] = l4
        # the long-read block (one of 65,536 x 16.5 kb reads): launches in
        # its main-path run, and the kernel on its QUAL stream
        way = "encode" if name == "lane_encode" else "decode"
        row["long_read"] = {"launches": lr[way]["launches"][name],
                            **lr["kernels"][name]}
        row["sharded_launches"] = _by_shard(shard, name)
        kernels.append(row)
    # Kernel C: one launch per block; its device time (profiler) is `ms`
    name = "compact_lanes_dev"
    row = {"name": name, "route": "cuda", "source": source[name],
           "replaces": replaces[name], "launches": launches[name],
           "match": errs[name] == 0, "max_abs_err": errs[name]}
    for lv, c, lc, err in ((3, comp, launches[name], errs[name]),
                           (4, comp4, launches4[name], errs4[name])):
        part = {"launches": lc, "max_abs_err": err, "ms": c["device_ms"],
                "wrapper_ms": c["wrapper_ms"], "plain_ms": c["plain_ms"],
                "plain_shape": "the same launch's streams, CUDA events",
                "bound_ms": c["bound_ms"], "bound_by": "bytes",
                "bound_fraction": c["bound_fraction"],
                "sector_bound_ms": c["sector_bound_ms"], "library_ms": None,
                "shape": f"one launch: the pinned L{lv} block's "
                         f"{len(c['streams'])} coded streams",
                "phase_ms": phases[lv]}
        if lv == 3:
            row.update(part, qual_alone=c["qual_alone"])
        else:
            row["l4"] = part
    row["long_read"] = {"launches": lr["encode"]["launches"][name],
                        "descriptors": lr["encode"]["descriptors"][name],
                        "shape": "the long block's QUAL alone",
                        **lr["kernels"][name]}
    row["sharded_launches"] = _by_shard(shard, name)
    kernels.append(row)
    # Kernel E in step slices: the long block's QUAL (its slices timed
    # with events, less their schedules); launches and slices from the
    # long block's main-path encode
    lk = lr["kernels"]
    kernels.append({
        "name": "lane_encode_sliced", "form": "step slices",
        "counted_as": "lane_encode", "route": "cuda",
        "source": source["lane_encode"],
        "replaces": "slimfastq_tpu/ops/streams_jax.py:298",
        "launches": lr["encode"]["launches"]["lane_encode"],
        "slices": lr["encode"]["slices"]["lane_encode"],
        "match": errs["lane_encode_sliced"] == 0,
        "max_abs_err": errs["lane_encode_sliced"],
        "ms": lk["lane_encode"]["ms"],
        "with_schedules_ms": lk["lane_encode"]["with_schedules_ms"],
        "plain_ms": lk["plain_ms_2_chunks"],
        "plain_shape": "the long QUAL's first 2 chunks in 2 slices, host "
                       "clock",
        "bound_ms": lk["lane_encode"]["bound_ms"], "bound_by": "bytes",
        "lockstep_ms": lk["lane_encode"]["lockstep_ms"],
        "library_ms": None,
        "shape": f"QUAL of the {LONG_READS} x {LONG_LEN} bp block: W = "
                 f"{lk['W']}, NC = {lk['NC']}, {lk['slices']} slices",
        "l1_shared_memory_table": l1})
    # the window forms: one launch over the blocks of a window, on the 16k
    # L3 window's own inputs (4 blocks of 16,384 records); launches (and
    # the descriptors they took: blocks for E and D, streams for C) from
    # the window path's run at level 3 and at level 4, counted under the
    # kernel's one name
    for name, key, base, replaced in (
            ("lane_encode_blocks", "lane_encode_blocks", "lane_encode",
             "slimfastq_tpu/parallel/mesh.py:44"),
            ("lane_decode_blocks", "lane_decode_blocks", "lane_decode",
             "slimfastq_tpu/parallel/mesh.py:75"),
            ("compact_streams_dev", "compact_window", "compact_lanes_dev",
             "slimfastq_tpu/ops/compact_pallas.py:40")):
        w = win[key]
        (l3, d3), (l4, d4) = wlaunches[3], wlaunches[4]
        row = {"name": name, "form": "window", "counted_as": base,
               "route": "cuda", "source": source[base],
               "replaces": replaced, "launches": l3[base],
               "descriptors": d3[base], "launches_l4": l4[base],
               "descriptors_l4": d4[base],
               "match": errs[key] == 0, "max_abs_err": errs[key],
               "library_ms": None, "bound_ms": w["bound_ms"],
               "bound_by": w.get("bound_by", "bytes")}
        if key == "compact_window":
            row.update(ms=w["device_ms"], wrapper_ms=w["wrapper_ms"],
                       plain_ms=w["plain_ms"],
                       plain_shape="the same launch's streams, CUDA events",
                       shape=f"one launch: the 16k L3 window's "
                             f"{w['streams']} coded streams")
        else:
            row.update(ms=w["ms"], plain_ms=w["plain_ms"],
                       plain_shape=w["plain_shape"] + ", host clock",
                       prefix_ms=w["prefix_ms"],
                       one_launch_a_block_sum_ms=w[
                           "one_launch_a_block_sum_ms"],
                       shape="QUAL of the 16k L3 window: 4 blocks, W = "
                             "1024",
                       window_coder_span=win["coder_span"])
        kernels.append(row)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(json.dumps({"earlier_ms": {
        "note": "recorded constants (this script, H100 80GB HBM3, 700 W), "
                "not measured in this run: E, D and C before the "
                "shared-memory table law, and C on QUAL alone when it took "
                "one launch per stream (CUDA events around the wrapper)",
        **EARLIER_MS}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--streaming-child"]:
        sys.exit(_streaming_child(sys.argv[2]))
    if sys.argv[1:2] == ["--gather-child"]:
        sys.exit(_gather_child(sys.argv[2]))
    sys.exit(main())
