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

Prints `compact_block_l3`, `compact_block_l4`, `compact_phase_l3`,
`compact_phase_l4`, `block`, `block_l4`, `wall`, `wall_l4`, `earlier_ms`
(recorded constants) and `kernels` JSON lines, then the card's name and
power limit and, as its last line, the `ok` JSON line.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# Recorded constants, printed on a line of their own (this script, H100
# 80GB HBM3, 700 W): each kernel's time at the timed shape before E and D
# moved their table law into shared memory, and Kernel C on QUAL alone
# when it took one launch per stream (CUDA events around the wrapper)
EARLIER_MS = {"before_smem_table_law": {"lane_encode": 142.01,
                                        "lane_decode": 136.97,
                                        "compact_lanes_dev": 0.0317},
              "one_launch_per_stream": {"compact_lanes_dev": 0.0325}}
BARRIER_ITERS = 200000


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
        _cuda.check(lib, lib.barrier_loop(iters, 1024, out.data_ptr(),
                                          _cuda.stream_ptr(out)),
                    "barrier_loop")
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
    idle = [k for k, v in launches.items() if v == 0]
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
          f"block flags {flags}, round trip exact, launches {launches}",
          flush=True)
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


def wall(dev, level: int) -> None:
    import torch
    from slimfastq_tpu_torch import api
    data = _pinned(READS * WALL_BLOCKS)
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

    plain, errs, plain4, errs4 = check_kernels(dev)
    check_ragged(dev, errs)
    data = _pinned(READS)
    times = time_kernels(data, dev, errs)
    times4 = time_kernels_l4(data, dev, errs4)
    comp = block_compaction(data, dev, 3, errs)
    comp4 = block_compaction(data, dev, 4, errs4)
    phases = {}
    for level in (3, 4):
        phases[level] = phase(data, level, dev)
        print(json.dumps({f"compact_phase_l{level}": phases[level]}),
              flush=True)
    bar_us = barrier_us(dev)
    print(json.dumps({"barrier_us": bar_us}), flush=True)
    launches = main_path(data, 3)
    spans = block_spans(data, dev)
    wall(dev, 3)
    launches4 = main_path(data, 4)
    spans4 = l4_spans(data, dev)
    wall(dev, 4)

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
    kernels.append(row)
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
    sys.exit(main())
