#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (slimfastq_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. kernels: each of Kernel E (lane_encode), D (lane_decode) and C
     (compact_lanes_dev) against its plain PyTorch version on the card,
     byte for byte, at W = 1024, Sp = 256 with the level-3 SEQ (all lanes
     at context 0 at every read start: the collision case, with 1,024 and
     with 700 active lanes, where the format's count field wraps) and QUAL
     geometries, and at the aux width W = 64 with the byte and flag kinds
     (tables in shared memory); then each kernel timed with CUDA events on
     the main path's own inputs (the pinned 64k x 100 bp block's QUAL
     stream: W = 1024, Sp = 6400, NC = 800), where C is held against its
     plain version once more and D's output against the packed QUAL
     symbols; and one 1,024-thread barrier timed, for D's lockstep bound
     (bit-steps x one barrier; E's is printed beside its byte bound);
  4. main path: the pinned block through api.encode_fastq / decode_fastq
     on the card: container size and SHA-256 equal the JAX package's,
     the round trip is exact, every kernel's launch count moved; then the
     block's seven E and seven D launches, on the main path's inputs,
     timed alone and launched at once through the main path's StreamSet
     (the block's coder span, first launch to join, beside the sum), and
     the main path's device halves timed with CUDA events; then encode
     and decode wall time over 4 blocks of the same generator.

Prints a `block`, an `earlier_ms` (recorded constants) and a `kernels`
JSON line, then, as its last line, the `ok` JSON line.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

# Pinned block (bench.py's shape): 65,536 reads x 100 bp, level 3.
READS, READ_LEN = 65536, 100
PINNED_BYTES = 2593846
# SHA-256 of the JAX package's container for the pinned block (its
# api.encode_fastq(data, level=3, backend=streams_jax), run on a CPU)
PINNED_SHA256 = \
    "056cae0e9fd312106cae2a401155a533840c167a46ced960fad355c4471a3f6c"
WALL_BLOCKS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# Each kernel's time at the timed shape before E and D moved their table
# law into shared memory (this script, H100 80GB HBM3, 700 W), printed on
# a line of its own as recorded constants
EARLIER_MS = {"lane_encode": 142.01, "lane_decode": 136.97,
              "compact_lanes_dev": 0.0317}
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


def _check_stream(kind, geom, syms_np, counts_np, pos, reset, dev, plain,
                  errs):
    """E, C and D on the card against their plain versions for one stream.
    Records the plain versions' times (ms) at this shape in `plain` and
    each kernel's largest difference in `errs`."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    Sp, W = syms_np.shape
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(dev)
    counts = torch.from_numpy(counts_np.astype(np.int32)).to(dev)
    idx_c, bit_c = ST._schedule(kind, geom, syms, pos, reset, counts)
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
    dec_k = coder_torch.lane_decode(*args, kind, geom)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec_p = coder_torch.lane_decode_plain(*args, kind, geom)
    torch.cuda.synchronize()
    plain["lane_decode"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_decode", f"lane_decode {kind} W={W}", dec_k,
             dec_p)
    mask = np.arange(Sp)[:, None] < counts_np[None, :]
    if not np.array_equal(dec_k.cpu().numpy()[mask], syms_np[mask]):
        raise AssertionError(f"{kind}: decode does not invert encode")


def check_kernels(dev):
    """All four coder kinds. Returns the plain versions' times in the QUAL
    case (the longest chain) at W = 1024, Sp = 256, and each kernel's
    largest absolute difference from its plain version."""
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
    print(f"kernels match their plain versions: seq (1,024 and 700 "
          f"colliding lanes)/qual at W={W} Sp={Sp}, byte/flag at W={Wa} "
          f"Sp={Sp}", flush=True)
    return plain_qual, errs


# ---------------------------------------------------------------------------
# phase 3b: kernel times on the main path's own inputs
# ---------------------------------------------------------------------------

def time_kernels(data: bytes, dev, errs: dict) -> dict:
    """Device times (ms) and byte bounds of E, C and D on the pinned block's
    QUAL stream (the longest serial chain of the block), whose inputs come
    from the main path's own setup (pipeline_native.prepare_block_fast,
    streams_torch.seq_qual_jobs). At this size C is also held against its
    plain version (recorded in `errs`) and D's output against the packed
    QUAL symbols."""
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
    c_ms = _time_ms(lambda: compact_torch.compact_lanes_dev(ebufs, eptrs,
                                                            Bmax), 20)
    c_plain_ms = _time_ms(lambda: compact_torch.compact_lanes_plain(
        ebufs, eptrs, Bmax), 5)
    c_bytes = int(totals.sum()) + eptrs.numel() * 4 + W * Bmax + W * 4
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
    out["compact_lanes_dev"] = (c_ms, c_bytes, c_plain_ms)
    out["lane_decode"] = (d_ms, d_bytes)
    print(f"kernels at the main path's shape: compact equals its plain "
          f"version (NC={NC}, W={W}), decode returns the packed QUAL "
          f"symbols", flush=True)
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

def main_path(data: bytes) -> dict:
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import _cuda
    _cuda.reset_launches()
    enc = api.encode_fastq(data, level=3, device="cuda")
    dec = api.decode_fastq(enc, device="cuda")
    launches = dict(_cuda.launches)
    if len(enc) != PINNED_BYTES:
        raise AssertionError(f"container is {len(enc)} bytes, expected "
                             f"{PINNED_BYTES}")
    sha = hashlib.sha256(enc).hexdigest()
    if sha != PINNED_SHA256:
        raise AssertionError(f"container SHA-256 {sha} differs from the JAX "
                             "package's")
    if dec != data:
        raise AssertionError("decode does not return the input")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    print(f"main path: {len(data)} raw -> {len(enc)} bytes, SHA-256 equals "
          f"the JAX package's, round trip exact, launches {launches}",
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


def wall(dev) -> None:
    import torch
    from slimfastq_tpu_torch import api
    data = _pinned(READS * WALL_BLOCKS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=3, device=dev)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device=dev)
    t_dec = time.perf_counter() - t
    if dec != data:
        raise AssertionError("4-block round trip is not exact")
    print(json.dumps({"wall": {
        "blocks": WALL_BLOCKS, "raw_bytes": len(data),
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

    plain, errs = check_kernels(dev)
    data = _pinned(READS)
    times = time_kernels(data, dev, errs)
    bar_us = barrier_us(dev)
    print(json.dumps({"barrier_us": bar_us}), flush=True)
    launches = main_path(data)
    spans = block_spans(data, dev)
    wall(dev)

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
    for name in ("lane_encode", "lane_decode", "compact_lanes_dev"):
        ms, nbytes, *full_plain = times[name]
        row = {
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "match": errs[name] == 0, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain[name],
            "plain_shape": "W=1024 Sp=256 qual",
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape}
        if full_plain:  # C's plain version is cheap at the full shape
            row["plain_ms"] = full_plain[0]
            row["plain_shape"] = (f"W={shape['W']} NC={shape['NC']} qual, "
                                  "CUDA events")
        else:
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
        kernels.append(row)
    print(json.dumps({"earlier_ms": {
        "note": "constants recorded before the shared-memory table law "
                "(this script, H100 80GB HBM3, 700 W), not measured in this "
                "run", **EARLIER_MS}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
