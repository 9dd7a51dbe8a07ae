"""Block assembly + per-block encode/decode orchestration: the pure-Python
host pipeline (the port's copy of the JAX package's pipeline.py, the
behavioural oracle of the native pipeline in pipeline_native.py).

``encode_block`` / ``decode_block`` code each stream through ``backend``:
the NumPy oracle (ops/streams_np) or a device (streams_torch.
DeviceBackend, which runs Kernels E, D and C stream by stream); the API
selects it (``use_native=False``). The data model, the stream inventory
and the lane layout below are shared by every path.

A *block* is a fixed-record-count, independently decodable unit — the
TPU-native replacement for slimfastq's single serial stream (SURVEY.md §2
"Container": per-block model state is what makes data-parallel encode/decode
and the multi-host ordered gather possible).

Record -> lane mapping is round-robin (record r -> lane r % W, slot r // W),
so lanes stay balanced. Per-record "previous" references for ID/length
delta modeling depend on the container format version (frozen rule):
format v3 deltas against the aux-lane-local previous record r-Wa (every
decode chain is lane-independent, so the host ID/LEN decode parallelises
over lanes; numeric ID deltas additionally store -Wa biased values so a
per-record counter costs zigzag(0)); v1/v2 delta against the globally
previous record r-1 (a single serial decode chain).

Stream inventory per block (fixed order):
  LEN   byte  — svarint(read_len - prev_len), prev per the fmt rule above
  FLAG  flag  — 3 bits/record: [id_exception, plus_plain, plus_is_idcopy]
  IDD   byte  — svarint digit-token deltas for flag=0 IDs
  IDX   byte  — varint-length-prefixed exception IDs and plus lines
  SEQX  byte  — non-ACGT exceptions: varint(gap in global base index) + char
  SEQ   2bit  — bases (exceptions coded as A), order-k rolling context
  QUAL  6/7bit— qualities biased by per-block minq
  MATCH byte  — (format v5) long-range read-match descriptors; when a
          block's flags bit0 is set, SEQ symbols are e-transformed over
          matched spans (models/matcher.py is the frozen rule). Format v5
          blocks also carry the SEQ context order actually used
          (seq_order; 0 = the geometry default) so small blocks can fall
          back to a shallower order (matcher.effective_seq_order policy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import CodecConfig
from .models import readid
from .ops import streams_np
from .utils.bits import get_svarint, get_varint, put_svarint, put_varint
from .utils.fastq import FastqBatch

U32 = np.uint32

STREAMS = ("LEN", "FLAG", "IDD", "IDX", "SEQX", "SEQ", "QUAL")
STREAMS_V5 = STREAMS + ("MATCH",)

MATCH_USED = 1     # EncodedBlock.flags bit0: SEQ symbols are e-transformed
QUAL_NODELTA = 2   # flags bit1: QUAL coded with delta_bits=0 (small block)


def streams_for(fmt: int):
    """Stream inventory for a container format version."""
    return STREAMS_V5 if fmt >= 5 else STREAMS

_BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_TO_CODE[_b] = _i
_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class EncodedStream:
    sym_counts: np.ndarray  # int64[W] symbols per lane
    lane_lens: np.ndarray   # int64[W] compressed bytes per lane
    payload: np.ndarray     # uint8[W, maxlen]


@dataclass
class EncodedBlock:
    num_records: int
    minq: int
    qual_depth: int
    streams: dict[str, EncodedStream]
    flags: int = 0      # v5: bit0 MATCH_USED
    seq_order: int = 0  # v5: SEQ context order used (0 = geometry default)

    def stream_order(self):
        return STREAMS_V5 if "MATCH" in self.streams else STREAMS


def _to_lane_streams(per_record: list[bytes | bytearray], W: int):
    """Concatenate per-record byte strings lane-major -> ([S,W] syms, counts)."""
    n = len(per_record)
    lane_bufs = [bytearray() for _ in range(W)]
    for r in range(n):
        lane_bufs[r % W] += per_record[r]
    counts = np.array([len(b) for b in lane_bufs], dtype=np.int64)
    S = int(counts.max()) if n else 0
    syms = np.zeros((S, W), dtype=U32)
    for w, b in enumerate(lane_bufs):
        if b:
            syms[: len(b), w] = np.frombuffer(bytes(b), dtype=np.uint8)
    return syms, counts


def _from_lane_streams(syms: np.ndarray, counts: np.ndarray) -> list[bytes]:
    """Inverse of _to_lane_streams at the whole-lane level."""
    W = syms.shape[1]
    return [syms[: counts[w], w].astype(np.uint8).tobytes() for w in range(W)]


def _to_lane_streams_perlane(per_lane: list, Wa: int):
    """Per-aux-lane byte buffers -> ([S, Wa] syms, counts)."""
    counts = np.array([len(b) for b in per_lane], dtype=np.int64)
    S = int(counts.max()) if counts.size else 0
    syms = np.zeros((S, Wa), dtype=U32)
    for w, b in enumerate(per_lane):
        if b:
            syms[: len(b), w] = np.frombuffer(bytes(b), dtype=np.uint8)
    return syms, counts


def _lane_lengths_matrix(lengths: np.ndarray, W: int) -> np.ndarray:
    """[Rpl, W] per-lane record lengths, 0-padded. Record r lands at
    (r // W, r % W), which flattens to index r — a pad + reshape (the
    2-D fancy-index scatter this replaces cost ~0.6 ms at 64k)."""
    n = len(lengths)
    Rpl = (n + W - 1) // W if n else 0
    mat = np.zeros((Rpl, W), dtype=np.int64)
    mat.reshape(-1)[:n] = lengths
    return mat


def _seq_symbol_layout(lengths: np.ndarray, W: int):
    """Lane layout for base/qual streams: counts[W], pos[S,W], reset[S,W]."""
    mat = _lane_lengths_matrix(lengths, W)
    counts = mat.sum(axis=0)
    S = int(counts.max()) if counts.size else 0
    pos, reset = streams_np.build_pos_reset(mat, S)
    return mat, counts, S, pos, reset


def _scatter_record_symbols(values_per_record: list[np.ndarray], W: int,
                            S: int, counts: np.ndarray) -> np.ndarray:
    """Pack per-record symbol arrays into the [S, W] lane-major matrix."""
    syms = np.zeros((S, W), dtype=U32)
    offs = np.zeros(W, dtype=np.int64)
    for r, vals in enumerate(values_per_record):
        w = r % W
        o = offs[w]
        syms[o: o + len(vals), w] = vals
        offs[w] = o + len(vals)
    assert np.array_equal(offs, counts)
    return syms


def _gather_record_symbols(syms: np.ndarray, lengths: np.ndarray, W: int
                           ) -> list[np.ndarray]:
    """Inverse of _scatter_record_symbols."""
    offs = np.zeros(W, dtype=np.int64)
    out = []
    for r in range(len(lengths)):
        w = r % W
        L = int(lengths[r])
        out.append(syms[offs[w]: offs[w] + L, w])
        offs[w] += L
    return out


def seqx_runs(bad_pos: np.ndarray, s: np.ndarray
              ) -> list[tuple[int, int, int]]:
    """Group sorted exception positions into maximal (start, len, char)
    runs of consecutive positions holding an identical character."""
    rs = int(bad_pos[0])
    ch = int(s[rs])
    ln = 1
    runs: list[tuple[int, int, int]] = []
    for p in bad_pos[1:]:
        p = int(p)
        if p == rs + ln and int(s[p]) == ch:
            ln += 1
        else:
            runs.append((rs, ln, ch))
            rs, ln, ch = p, 1, int(s[p])
    runs.append((rs, ln, ch))
    return runs


def parse_seqx_lane(buf, fmt: int) -> list[tuple[int, int, int]]:
    """Parse one aux-lane SEQX stream into (record_ordinal, pos, char)
    triples. fmt>=2 items are (drec, dstart, runlen-1, char) run records;
    fmt==1 items are per-base (drec, dpos, char)."""
    out: list[tuple[int, int, int]] = []
    p = 0
    ordinal = -1
    prev_end = 0
    prev_pos = -1
    while p < len(buf):
        drec, p = get_varint(buf, p)
        dpos, p = get_varint(buf, p)
        if fmt >= 2:
            runl, p = get_varint(buf, p)
        else:
            runl = 0
        ch = buf[p]
        p += 1
        if drec:
            ordinal += drec
            start = dpos
        else:
            start = (prev_end + dpos) if fmt >= 2 else (prev_pos + dpos)
        for k in range(runl + 1):
            out.append((ordinal, start + k, int(ch)))
        prev_end = start + runl
        prev_pos = start
    return out


def stream_jobs(batch: FastqBatch, cfg: CodecConfig):
    """Host-side modeling: produce every stream's (kind, geom, syms, counts,
    pos, reset) coding job plus the block metadata. Used by encode_block and
    by the benchmark harness (which times the device kernels in isolation).

    Returns (jobs, n, minq, qual_depth, extra); extra carries the v5
    per-block decisions: ``seq_order`` (nonzero when the effective SEQ
    order fell back below the geometry default) and ``match_trials``, a
    list of (min_score, seq_syms_e, match_syms, match_counts) SEQ-stream
    alternatives for encode_block's per-block trial.
    """
    n = len(batch)
    W, Wa = cfg.lanes, cfg.aux_lanes
    lengths = np.array([len(s) for s in batch.seqs], dtype=np.int64)

    # --- host-side per-record modeling ------------------------------------
    # Delta baseline (frozen per container format version): format v3
    # uses the aux-lane-local previous record r-Wa, which makes every
    # decode chain lane-independent (the host ID/LEN decode parallelises
    # over the Wa lanes); v1/v2 used the globally previous record r-1
    # (slightly tighter deltas, but a single serial decode chain).
    step = Wa if cfg.fmt >= 3 else 1
    len_rec: list[bytearray] = []
    flag_rec: list[bytes] = []
    idd_lane = [bytearray() for _ in range(Wa)]
    idx_lane = [bytearray() for _ in range(Wa)]
    for r in range(n):
        w = r % Wa
        b = bytearray()
        # v3 prologue: records r < step delta against r-1 (global), so a
        # small file does not pay `step` absolute heads
        pidx = r - step if r >= step else r - 1
        prev_len = int(lengths[pidx]) if pidx >= 0 else 0
        put_svarint(b, int(lengths[r]) - prev_len)
        len_rec.append(b)

        prev_id = batch.ids[pidx] if pidx >= 0 else None
        f_id = readid.encode_record_id(
            prev_id, batch.ids[r], idd_lane[w], idx_lane[w],
            delta_bias=step if (step > 1 and r >= step) else 0)
        plus = batch.pluses[r]
        if plus == b"+":
            f_pp, f_pc = 1, 0
        elif plus == b"+" + batch.ids[r]:
            f_pp, f_pc = 0, 1
        else:
            f_pp, f_pc = 0, 0
            put_varint(idx_lane[w], len(plus))
            idx_lane[w] += plus
        flag_rec.append(bytes([f_id, f_pp, f_pc]))

    # --- sequence: 2-bit codes + run-length exceptions --------------------
    # Non-ACGT bases come in runs (N homopolymers); coding them per run
    # instead of per base makes an all-N read cost O(1) exception bytes
    # (SURVEY.md §2 sequence codec: N-runs handled out-of-band).
    # Format v2 per run, aux-lane-local: varint(rec_ordinal_delta);
    # varint(start) if new record else varint(start - prev_run_end);
    # varint(run_len - 1); char.
    seq_codes: list[np.ndarray] = []
    seqx_rec: list[bytearray] = []
    prev_xrec = [-1] * Wa  # per aux-lane ordinal of last record with an exc
    for r in range(n):
        s = np.frombuffer(batch.seqs[r], dtype=np.uint8)
        codes = _BASE_TO_CODE[s]
        bad = codes == 255
        xb = bytearray()
        if bad.any():
            w = r % Wa
            ordinal = r // Wa
            bp = np.nonzero(bad)[0]
            runs = seqx_runs(bp, s)
            prev_end = 0
            for i, (st, ln, ch) in enumerate(runs):
                if i == 0:
                    put_varint(xb, ordinal - prev_xrec[w])
                    put_varint(xb, st)
                else:
                    put_varint(xb, 0)
                    put_varint(xb, st - prev_end)
                put_varint(xb, ln - 1)
                xb.append(ch)
                prev_end = st + ln - 1
            prev_xrec[w] = ordinal
            codes = np.where(bad, 0, codes)
        seqx_rec.append(xb)
        seq_codes.append(codes.astype(U32))

    # --- quality: bias by block minq, choose tree depth -------------------
    if n and max(len(q) for q in batch.quals) > 0:
        minq = min(min(q) for q in batch.quals if q)
        maxq = max(max(q) for q in batch.quals if q)
    else:
        minq, maxq = 33, 33
    qrange = maxq - minq + 1
    # depth-8 fallback keeps the lossless guarantee for blocks whose quality
    # alphabet spans more than 128 values (any byte value is representable)
    qual_depth = 6 if qrange <= 64 else (7 if qrange <= 128 else 8)
    qual_syms_rec = [
        (np.frombuffer(q, dtype=np.uint8).astype(U32) - U32(minq))
        for q in batch.quals
    ]

    # --- lay out lane matrices --------------------------------------------
    jobs: dict[str, tuple] = {}

    def byte_job(name: str, per_rec_or_lane, per_lane: bool = False):
        if per_lane:
            syms, counts = _to_lane_streams_perlane(per_rec_or_lane, Wa)
        else:
            syms, counts = _to_lane_streams(per_rec_or_lane, Wa)
        jobs[name] = ("byte", cfg.bytes_, syms, counts, None, None)

    byte_job("LEN", len_rec)
    byte_job("IDD", idd_lane, per_lane=True)
    byte_job("IDX", idx_lane, per_lane=True)
    byte_job("SEQX", seqx_rec)

    fsyms, fcounts = _to_lane_streams(flag_rec, Wa)
    jobs["FLAG"] = ("flag", cfg.flags, fsyms, fcounts, None, None)

    from dataclasses import replace

    # --- v5: per-block SEQ order fallback + long-range match trials --------
    extra = {"seq_order": 0, "match_trials": [], "qual_nodelta": False}
    sgeom = cfg.seq
    if cfg.fmt >= 5:
        from .models import matcher as M
        eff = M.effective_seq_order(cfg.seq.order, int(lengths.sum()))
        if eff != cfg.seq.order:
            sgeom = replace(cfg.seq, order=eff)
            extra["seq_order"] = eff

    _, scounts, S, pos, reset = _seq_symbol_layout(lengths, W)
    sq = _scatter_record_symbols(seq_codes, W, S, scounts)
    jobs["SEQ"] = ("seq", sgeom, sq, scounts, pos, reset)

    if cfg.fmt >= 5:
        empty = np.zeros((0, Wa), dtype=U32)
        zc = np.zeros(Wa, dtype=np.int64)
        jobs["MATCH"] = ("byte", cfg.bytes_, empty, zc, None, None)
        if getattr(cfg, "match", False) and sgeom.match_bits \
                and n > M.MATCH_CHUNK:
            codes8 = [c.astype(np.uint8) for c in seq_codes]
            matches = M.find_matches(codes8)
            for t in M.THRESHOLDS:
                if not any(m is not None and m[3] >= t for m in matches):
                    continue
                e8 = M.apply_e_transform(codes8, matches, t)
                sq_e = _scatter_record_symbols(
                    [e.astype(U32) for e in e8], W, S, scounts)
                per_read = [m[:3] if (m and m[3] >= t) else None
                            for m in matches]
                mfl = [np.zeros(len(c), dtype=np.uint8) for c in codes8]
                for (r, lo_, hi_) in M.spans(per_read, lengths):
                    mfl[r][lo_:hi_] = 1
                mflag = _scatter_record_symbols(
                    [f.astype(U32) for f in mfl], W, S, scounts)
                mlanes = M.encode_match_lanes(matches, t, n, Wa)
                msyms, mcounts = _to_lane_streams_perlane(mlanes, Wa)
                extra["match_trials"].append((t, sq_e, msyms, mcounts,
                                              mflag))

    qs = _scatter_record_symbols(qual_syms_rec, W, S, scounts)
    qdelta = cfg.qual.delta_bits
    if cfg.fmt >= 5 and qdelta:
        from .models import matcher as M
        qdelta = M.effective_qual_delta(qdelta, int(lengths.sum()))
        extra["qual_nodelta"] = qdelta == 0
    qgeom = replace(cfg.qual, depth=qual_depth, delta_bits=qdelta)
    jobs["QUAL"] = ("qual", qgeom, qs, scounts, pos, reset)

    return jobs, n, int(minq), qual_depth, extra


def decode_block_lengths(blk: EncodedBlock, cfg: CodecConfig,
                         backend=streams_np) -> np.ndarray:
    """Decode just the LEN stream of a block into per-record read lengths
    (the single piece every decode path needs first, shared so the format
    logic lives in exactly one place)."""
    es = blk.streams["LEN"]
    S = int(es.sym_counts.max()) if es.sym_counts.size else 0
    syms = backend.decode_stream("byte", cfg.bytes_, es.payload,
                                 es.lane_lens, es.sym_counts, S)
    lanes = _from_lane_streams(syms, np.asarray(es.sym_counts))
    n = blk.num_records
    Wa = cfg.aux_lanes
    step = Wa if cfg.fmt >= 3 else 1
    lengths = np.zeros(n, dtype=np.int64)
    lane_pos = [0] * Wa
    for r in range(n):
        w = r % Wa
        d, lane_pos[w] = get_svarint(lanes[w], lane_pos[w])
        pidx = r - step if r >= step else r - 1
        lengths[r] = (int(lengths[pidx]) if pidx >= 0 else 0) + d
    return lengths


def choose_match_variant(jobs, extra, backend):
    """Per-block trial (format v5): code the SEQ stream plain and at each
    match threshold, keep the smallest seq+match total. Returns
    (flags, seq_payload, seq_lens, match_stream) where match_stream is the
    EncodedStream for the MATCH slot (empty when plain wins)."""
    kind, geom, syms, counts, pos, reset = jobs["SEQ"]
    payload, lens = backend.encode_stream(kind, geom, syms, counts,
                                          pos=pos, reset=reset)
    _, bgeom, esyms, ecounts, _, _ = jobs["MATCH"]
    best = (int(np.asarray(lens).sum()), 0, payload, lens,
            EncodedStream(ecounts, np.zeros_like(ecounts),
                          np.zeros((len(ecounts), 0), dtype=np.uint8)))
    for (_t, sq_e, msyms, mcounts, mflag) in extra["match_trials"]:
        ep, el = backend.encode_stream(kind, geom, sq_e, counts,
                                       pos=pos, reset=reset, mflag=mflag)
        mp, ml = backend.encode_stream("byte", bgeom, msyms, mcounts)
        total = int(np.asarray(el).sum()) + int(np.asarray(ml).sum())
        if total < best[0]:
            best = (total, MATCH_USED, ep, el,
                    EncodedStream(mcounts, ml, mp))
    return best[1], best[2], best[3], best[4]


def encode_block(batch: FastqBatch, cfg: CodecConfig,
                 backend=streams_np) -> EncodedBlock:
    jobs, n, minq, qual_depth, extra = stream_jobs(batch, cfg)
    streams: dict[str, EncodedStream] = {}
    flags = 0
    for name in streams_for(cfg.fmt):
        if name in ("SEQ", "MATCH"):
            continue
        kind, geom, syms, counts, pos, reset = jobs[name]
        payload, lens = backend.encode_stream(kind, geom, syms, counts,
                                              pos=pos, reset=reset)
        streams[name] = EncodedStream(counts, lens, payload)
    if cfg.fmt >= 5:
        flags, sp, sl, mstream = choose_match_variant(jobs, extra, backend)
        if extra["qual_nodelta"]:
            flags |= QUAL_NODELTA
        streams["SEQ"] = EncodedStream(jobs["SEQ"][3], sl, sp)
        streams["MATCH"] = mstream
    else:
        kind, geom, syms, counts, pos, reset = jobs["SEQ"]
        payload, lens = backend.encode_stream(kind, geom, syms, counts,
                                              pos=pos, reset=reset)
        streams["SEQ"] = EncodedStream(counts, lens, payload)
    return EncodedBlock(n, minq, qual_depth, streams, flags=flags,
                        seq_order=extra["seq_order"])


def decode_block(blk: EncodedBlock, cfg: CodecConfig,
                 backend=streams_np) -> FastqBatch:
    n = blk.num_records
    W, Wa = cfg.lanes, cfg.aux_lanes

    def dec_bytes(name: str, kind: str = "byte", geom=None,
                  pos=None, reset=None):
        es = blk.streams[name]
        g = geom if geom is not None else cfg.bytes_
        S = int(es.sym_counts.max()) if es.sym_counts.size else 0
        return backend.decode_stream(kind, g, es.payload, es.lane_lens,
                                     es.sym_counts, S, pos=pos, reset=reset)

    # 1. lengths
    lengths = decode_block_lengths(blk, cfg, backend)

    # 2. flags (counts implicit: 3 per record, round-robin over aux lanes)
    fs = blk.streams["FLAG"]
    rec_per_lane = (n - np.arange(Wa) + Wa - 1) // Wa
    fcounts = 3 * rec_per_lane
    fS = int(fcounts.max()) if fcounts.size else 0
    fsyms = backend.decode_stream("flag", cfg.flags, fs.payload,
                                  fs.lane_lens, fcounts, fS)
    flag_lanes = [fsyms[: fcounts[w], w] for w in range(Wa)]

    # 3. IDs + plus lines
    idd_syms = dec_bytes("IDD")
    idx_syms = dec_bytes("IDX")
    idd_lanes = _from_lane_streams(idd_syms, blk.streams["IDD"].sym_counts)
    idx_lanes = _from_lane_streams(idx_syms, blk.streams["IDX"].sym_counts)
    ids: list[bytes] = []
    pluses: list[bytes] = []
    step = Wa if cfg.fmt >= 3 else 1
    dpos = [0] * Wa
    xpos = [0] * Wa
    fpos = [0] * Wa
    for r in range(n):
        w = r % Wa
        f_id = int(flag_lanes[w][fpos[w]])
        f_pp = int(flag_lanes[w][fpos[w] + 1])
        f_pc = int(flag_lanes[w][fpos[w] + 2])
        fpos[w] += 3
        pidx = r - step if r >= step else r - 1
        prev_id = ids[pidx] if pidx >= 0 else None
        rid, dpos[w], xpos[w] = readid.decode_record_id(
            prev_id, f_id, idd_lanes[w], dpos[w], idx_lanes[w], xpos[w],
            delta_bias=step if (step > 1 and r >= step) else 0)
        ids.append(rid)
        if f_pp:
            pluses.append(b"+")
        elif f_pc:
            pluses.append(b"+" + rid)
        else:
            ln, xpos[w] = get_varint(idx_lanes[w], xpos[w])
            pluses.append(bytes(idx_lanes[w][xpos[w]: xpos[w] + ln]))
            xpos[w] += ln

    # 4. sequence exceptions -> per-record (pos, char) lists
    sx_syms = dec_bytes("SEQX")
    sx_lanes = _from_lane_streams(sx_syms, blk.streams["SEQX"].sym_counts)
    exc_by_rec: dict[int, list[tuple[int, int]]] = {}
    for w in range(Wa):
        for ordinal, bpos, ch in parse_seqx_lane(sx_lanes[w], cfg.fmt):
            exc_by_rec.setdefault(w + ordinal * Wa, []).append((bpos, ch))

    # 5. v5 match descriptors (parsed BEFORE the SEQ decode: the match
    # spans select the dedicated context family inside the seq coder)
    per_read: list = [None] * n
    mflag = None
    if cfg.fmt >= 5 and (blk.flags & MATCH_USED):
        from .models import matcher as M
        ms = blk.streams["MATCH"]
        m_syms = backend.decode_stream("byte", cfg.bytes_, ms.payload,
                                       ms.lane_lens, ms.sym_counts,
                                       int(ms.sym_counts.max())
                                       if len(ms.sym_counts) else 0)
        m_lanes = _from_lane_streams(m_syms, np.asarray(ms.sym_counts))
        for w in range(Wa):
            for ordinal, rd, orient, v in M.parse_match_lane(m_lanes[w]):
                r = w + ordinal * Wa
                # mirror native match_parse's bounds checks so both host
                # paths reject crafted/corrupt descriptors identically
                if r < 0 or r >= n or rd <= 0 or rd > r:
                    raise ValueError("corrupt MATCH descriptor")
                per_read[r] = (r - rd, orient, v)
        mfl = [np.zeros(int(L), dtype=np.uint8) for L in lengths]
        for (r, lo_, hi_) in M.spans(per_read, lengths):
            mfl[r][lo_:hi_] = 1

    # 5/6. seq + qual lane streams
    _, scounts, S, pos, reset = _seq_symbol_layout(lengths, W)
    if cfg.fmt >= 5 and (blk.flags & MATCH_USED):
        mflag = _scatter_record_symbols(
            [f.astype(U32) for f in mfl], W, S, scounts)
    ss = blk.streams["SEQ"]
    from dataclasses import replace as _replace
    sgeom = (_replace(cfg.seq, order=blk.seq_order)
             if (cfg.fmt >= 5 and blk.seq_order) else cfg.seq)
    seq_syms = backend.decode_stream("seq", sgeom, ss.payload, ss.lane_lens,
                                     scounts, S, pos=pos, reset=reset,
                                     mflag=mflag)
    qs = blk.streams["QUAL"]
    qgeom = _replace(cfg.qual, depth=blk.qual_depth,
                     delta_bits=0 if (blk.flags & QUAL_NODELTA)
                     else cfg.qual.delta_bits)
    qual_syms = backend.decode_stream("qual", qgeom, qs.payload, qs.lane_lens,
                                      scounts, S, pos=pos, reset=reset)

    seq_rec = _gather_record_symbols(seq_syms, lengths, W)
    qual_rec = _gather_record_symbols(qual_syms, lengths, W)

    # v5: undo the e-transform over matched spans (refs walk in order)
    if cfg.fmt >= 5 and (blk.flags & MATCH_USED):
        from .models import matcher as M
        codes = [(seq_rec[r] & 3).astype(np.uint8) for r in range(n)]
        M.reconstruct(codes, per_read)
        seq_rec = codes

    seqs: list[bytes] = []
    quals: list[bytes] = []
    for r in range(n):
        arr = _CODE_TO_BASE[seq_rec[r].astype(np.uint8) & 3].copy()
        for p, ch in exc_by_rec.get(r, ()):
            arr[p] = ch
        seqs.append(arr.tobytes())
        quals.append((qual_rec[r].astype(np.uint8)
                      + np.uint8(blk.minq)).tobytes())

    return FastqBatch(ids, seqs, pluses, quals)
