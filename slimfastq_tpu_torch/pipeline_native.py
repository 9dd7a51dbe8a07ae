"""Block pipeline: C++ host modelling (native/) + the PyTorch device drivers
(ops/streams_torch).

Byte-format identical to the JAX package's pipeline. Works directly on the
raw FASTQ buffer + index arrays, never materialising per-record Python
objects. SEQ and QUAL always take the device-raw path: the block's raw
bytes cross to the device once and the lane pack/unpack happens there; the
aux streams (LEN, FLAG, IDD, IDX, SEQX and a v5 block's MATCH) are
modelled on the host and coded on the device.

A window of blocks (the small-block path: ``encode_prepared_blocks``,
``decode_blocks_device``) is coded together: each stream's Kernel E or D
launch takes every block of the window; the one-block entries are its
one-block case.

Format v5 long-range matches (level 4): the host matcher finds each read's
reference read; per threshold of matcher.THRESHOLDS a trial rewrites the
matched spans with e-transform letters and codes SEQ again with the
match-context family, plus the MATCH descriptor stream; a trial that makes
SEQ + MATCH strictly smaller wins and sets MATCH_USED.

A block whose raw byte span reaches 2 GiB (long reads: 65,536 records of
~16.4 kb and more) packs SEQ and QUAL into lanes on the host
(native.pack_lanes) and unpacks them there on decode, as the JAX package
does: the device pack would need [S, W] int64 indices. Its streams take
the same coders, with pos/reset derived on the device (Kernel L's
step-input mode), each stream in one Kernel E launch. The byte budget
of a window (api) codes such a block alone.

The NumPy oracle (``api.Oracle``, ``--backend oracle``) codes blocks
prepared the same way with their lanes packed on the host
(``prepare_block_fast(host_pack=True)``): every stream through
ops/streams_np with host pos/reset (``encode_prepared_block_oracle``,
``decode_block_oracle``), no device at all.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import numpy as np

from . import native
from .config import CodecConfig
from .models import matcher as M
from .ops import pack_torch, streams_np, streams_torch
from .ops.ranger import pad_steps
from .pipeline import (MATCH_USED, QUAL_NODELTA, EncodedBlock, EncodedStream,
                       _BASE_TO_CODE, _CODE_TO_BASE, _lane_lengths_matrix,
                       streams_for)
from .utils.stats import trace

# device-side byte<->symbol maps (full 256-entry tables, gather-friendly):
# encode maps non-ACGT to symbol 0 (the SEQX stream patches them back on
# decode); decode maps any symbol byte through its low 2 bits
_BASE_TO_CODE_DEV = np.where(_BASE_TO_CODE == 255, 0,
                             _BASE_TO_CODE).astype(np.uint8)
_CODE_TO_BASE_FULL = _CODE_TO_BASE[np.arange(256) & 3].astype(np.uint8)

# raw bytes from which a block packs on the host (the JAX package's
# int32-offset limit)
_MAX_SPAN = 1 << 31


def numpy_empty(nbytes: int) -> np.ndarray:
    """A u8 host buffer of ``nbytes`` (pageable; contents undefined)."""
    return np.empty(nbytes, dtype=np.uint8)


def block_span(idx: dict, lo: int, hi: int) -> int:
    """Raw bytes of records [lo, hi): '@' of the first to the end of the
    last's quality line."""
    if hi <= lo:
        return 0
    last = hi - 1
    return int(idx["qual_off"][last] + idx["qual_len"][last]) \
        - (int(idx["id_off"][lo]) - 1)


def _lanes_to_mat(lanes_b, Wa: int):
    """Per-lane byte buffers -> ([S, Wa] u8 matrix, counts). Row-major
    fill (contiguous memcpy per lane) + one blocked C++ transpose."""
    counts = np.array([len(b) for b in lanes_b], dtype=np.int64)
    S = int(counts.max()) if counts.size else 0
    if S == 0:
        return np.zeros((0, Wa), dtype=np.uint8), counts
    symsT = np.zeros((Wa, S), dtype=np.uint8)
    for w, b in enumerate(lanes_b):
        if len(b):
            symsT[w, : len(b)] = b
    return native.transpose_mat(symsT), counts


def stream_jobs_fast(data: np.ndarray, idx: dict, lo: int, hi: int,
                     cfg: CodecConfig, host_pack: bool = False):
    """Every stream's (kind, geom, syms, counts, pos, reset) coding job,
    straight from the raw buffer + index arrays. SEQ and QUAL jobs carry
    pos = reset = None (derived on the device) and syms = None: their
    lane pack happens on the device, the host only runs the non-ACGT
    census for SEQX; with ``host_pack``, syms are their [S, W] u8 lanes,
    packed on the host with the same census.
    Returns (jobs, n, minq, qual_depth, ll_mat, extra); extra["matches"]
    holds the matcher's (ref, orient, v, score) arrays, or None where no
    read matched."""
    n = hi - lo
    W, Wa = cfg.lanes, cfg.aux_lanes
    sl = slice(lo, hi)
    seq_off = idx["seq_off"][sl]
    qual_off = idx["qual_off"][sl]
    lengths = idx["seq_len"][sl].astype(np.int64)

    jobs: dict[str, tuple] = {}
    prev_step = Wa if cfg.fmt >= 3 else 1  # delta baseline (frozen/fmt)

    # --- LEN ---------------------------------------------------------------
    lsyms, lcounts = _lanes_to_mat(native.lens_encode(lengths, Wa,
                                                      prev_step), Wa)
    jobs["LEN"] = ("byte", cfg.bytes_, lsyms, lcounts, None, None)

    # --- IDs + plus: flags/IDD/IDX -----------------------------------------
    bidx = {k: np.ascontiguousarray(idx[k][sl])
            for k in ("id_off", "id_len", "plus_off", "plus_len")}
    flags, dl, xl = native.ids_encode(data, bidx, n, Wa, prev_step)
    # FLAG stream: 3 symbols per record, lane-grouped (row-major fill +
    # one transpose)
    f3 = flags.reshape(n, 3)
    rec_per_lane = ((n - np.arange(Wa) + Wa - 1) // Wa
                    if n else np.zeros(Wa, dtype=np.int64))
    fcounts = (3 * rec_per_lane).astype(np.int64)
    maxrec = int(rec_per_lane.max()) if n else 0
    if maxrec:
        fT = np.zeros((Wa, 3 * maxrec), dtype=np.uint8)
        for w in range(Wa):
            sub = f3[w::Wa]
            if sub.size:
                fT[w, : sub.size] = sub.ravel()
        fsyms = native.transpose_mat(fT)
    else:
        fsyms = np.zeros((0, Wa), dtype=np.uint8)
    jobs["FLAG"] = ("flag", cfg.flags, fsyms, fcounts, None, None)

    for name, lanes_b in (("IDD", dl), ("IDX", xl)):
        syms, counts = _lanes_to_mat(lanes_b, Wa)
        jobs[name] = ("byte", cfg.bytes_, syms, counts, None, None)

    # --- SEQ + SEQX ---------------------------------------------------------
    ll_mat = _lane_lengths_matrix(lengths, W)
    scounts = ll_mat.sum(axis=0)
    S = int(scounts.max()) if scounts.size else 0
    sq = qs = None
    if host_pack:
        sq, _, nbad, rec_bad = native.pack_lanes(data, seq_off, lengths, W,
                                                 S, map256=_BASE_TO_CODE,
                                                 dtype=np.uint8)
    else:
        nbad, rec_bad = native.scan_bad(data, seq_off, lengths)
    if nbad:
        # rare path: run-length exception lane streams, emitted in C++;
        # only the records scan_bad flagged are rescanned
        seqx_lane = native.seqx_encode(data, seq_off, lengths, Wa,
                                       rec_bad=rec_bad, nbad=nbad)
    else:
        seqx_lane = [np.zeros(0, dtype=np.uint8)] * Wa
    sxsyms, sx_counts = _lanes_to_mat(seqx_lane, Wa)
    jobs["SEQX"] = ("byte", cfg.bytes_, sxsyms, sx_counts, None, None)

    # --- v5: per-block SEQ order fallback + long-range matches -------------
    extra = {"seq_order": 0, "qual_nodelta": False, "matches": None}
    sgeom = cfg.seq
    if cfg.fmt >= 5:
        eff = M.effective_seq_order(cfg.seq.order, int(lengths.sum()))
        if eff != cfg.seq.order:
            sgeom = replace(cfg.seq, order=eff)
            extra["seq_order"] = eff
        jobs["MATCH"] = ("byte", cfg.bytes_,
                         np.zeros((0, Wa), dtype=np.uint8),
                         np.zeros(Wa, dtype=np.int64), None, None)
        if cfg.match and sgeom.match_bits and n > M.MATCH_CHUNK:
            m_arrs = native.match_find_arrays(data, seq_off, lengths,
                                              min(M.THRESHOLDS))
            if (m_arrs[0] >= 0).any():
                extra["matches"] = m_arrs
    jobs["SEQ"] = ("seq", sgeom, sq, scounts, None, None)

    # --- QUAL ---------------------------------------------------------------
    if n and int(lengths.sum()):
        minq, maxq = native.minmax_ranges(data, qual_off, lengths)
    else:
        minq = maxq = 33
    qrange = maxq - minq + 1
    qual_depth = 6 if qrange <= 64 else (7 if qrange <= 128 else 8)
    if host_pack:
        qs = native.pack_lanes(data, qual_off, lengths, W, S, bias=minq,
                               dtype=np.uint8)[0]
    qdelta = cfg.qual.delta_bits
    if cfg.fmt >= 5 and qdelta:
        qdelta = M.effective_qual_delta(qdelta, int(lengths.sum()))
        extra["qual_nodelta"] = qdelta == 0
    qgeom = replace(cfg.qual, depth=qual_depth, delta_bits=qdelta)
    jobs["QUAL"] = ("qual", qgeom, qs, scounts, None, None)

    return jobs, n, minq, qual_depth, ll_mat, extra


def _match_span_bounds(m_arr, lengths):
    """Vectorised frozen span rule -> (los, his) in read coords."""
    recs, refs, orients, vs = m_arr
    L = lengths[recs]
    Lref = lengths[refs]
    o1 = orients.astype(bool)
    los = np.where(o1, np.maximum(0, L + vs - Lref), np.maximum(0, -vs))
    his = np.where(o1, np.minimum(L, L + vs), np.minimum(L, Lref - vs))
    return los, his


def _match_trials(matches, raw_args, W: int, Wa: int, S: int,
                  host=None, empty=numpy_empty) -> list:
    """The per-threshold SEQ alternatives of a block whose reads matched,
    in threshold order: [(min_score, the block's SEQ with the matched
    spans rewritten, MATCH syms [S', Wa], MATCH counts, mflag [S, W])]. A
    threshold that accepts no read has none, and so has one that accepts
    the same reads as the one before: its trial would code the same bytes,
    which can never win the strict test against their twin. The rewritten
    SEQ is raw_args with its padded bytes rewritten (the device pack), in
    a buffer from ``empty`` (as prepare_block_fast's); or,
    for a block packed on the host (raw_args None, host = (its raw bytes,
    seq offsets into them, lengths)), the rewritten bytes' SEQ lanes
    [S, W] u8, packed on the host."""
    refs, orients, vs, scores = matches
    if raw_args is not None:
        dpad, offs_s, offs_q, lengths = raw_args
    else:
        raw, offs_s, lengths = host
    trials, prev = [], None
    for t in M.THRESHOLDS:
        acc = (refs >= 0) & (scores >= t)
        if not acc.any() or (prev is not None and np.array_equal(acc, prev)):
            continue
        prev = acc
        msyms, mcounts = _lanes_to_mat(
            native.match_encode_lanes(matches, t, len(lengths), Wa), Wa)
        recs = np.flatnonzero(acc)
        los, his = _match_span_bounds(
            (recs, refs[recs], orients[recs], vs[recs]), lengths)
        mflag = native.match_mflag(recs, los, his, lengths, W, S)
        # the spans rewritten with e-transform letters, refs read from the
        # unmodified bytes (the reference's _e_rewrite_letters)
        if raw_args is not None:
            dpad_e = empty(len(dpad))
            dpad_e[:] = dpad
            native.match_apply_arrays(dpad_e, dpad, offs_s, lengths,
                                      matches, t)
            alt = (dpad_e, offs_s, offs_q, lengths)
        else:
            raw_e = raw.copy()
            native.match_apply_arrays(raw_e, raw, offs_s, lengths, matches,
                                      t)
            alt = native.pack_lanes(raw_e, offs_s, lengths, W, S,
                                    map256=_BASE_TO_CODE, dtype=np.uint8)[0]
            del raw_e
        trials.append((t, alt, msyms, mcounts, mflag))
    return trials


def prepare_block_fast(data: np.ndarray, idx: dict, lo: int, hi: int,
                       cfg: CodecConfig, host_pack: bool = False,
                       empty=numpy_empty, call: int | None = None):
    """Host-only half of a block encode (stream modelling + aux lane
    matrices + the padded raw byte range, or SEQ/QUAL lanes packed on the
    host where that range reaches _MAX_SPAN or ``host_pack`` asks for
    them + a v5 block's match trials). The returned opaque tuple feeds
    encode_prepared_block (or encode_prepared_block_oracle) — split so a
    pipelined caller can prep block k+1 while block k is on the device.
    ``empty(nbytes)`` gives the u8 buffers the padded range and the
    trials' rewritten copies are written into: page-locked ones
    (pack_torch.pinned_empty) for a card, so they go up in one
    asynchronous copy each; numpy_empty's by default. ``call``: the api
    call id its span takes (it runs on a pool's thread)."""
    with trace("sfq.encode.prep", call=call):
        span = block_span(idx, lo, hi)
        host = host_pack or span >= _MAX_SPAN
        jobs, n, minq, qual_depth, ll_mat, extra = stream_jobs_fast(
            data, idx, lo, hi, cfg, host_pack=host)
        raw_args = host_args = None
        sl = slice(lo, hi)
        base = int(idx["id_off"][lo]) - 1 if n else 0  # the record's '@'
        if n and not host:
            # the block's raw byte range ships to the device once, padded to
            # the shape bucket here, in the pipelined host half; offsets
            # become block-local
            dpad = empty(pack_torch.pad_flat(span))
            dpad[:span] = data[base:base + span]
            dpad[span:] = 0
            raw_args = (dpad, idx["seq_off"][sl] - base,
                        idx["qual_off"][sl] - base,
                        idx["seq_len"][sl].astype(np.int64))
        elif n:
            host_args = (data[base:base + span], idx["seq_off"][sl] - base,
                         idx["seq_len"][sl].astype(np.int64))
        v5 = None
        if cfg.fmt >= 5:
            matches = extra.pop("matches")
            v5 = {**extra, "trials": [] if matches is None else _match_trials(
                matches, raw_args, cfg.lanes, cfg.aux_lanes,
                int(ll_mat.sum(0).max()), host_args, empty)}
        return jobs, n, minq, qual_depth, ll_mat, raw_args, v5


def device_bytes(pre, cfg: CodecConfig) -> int:
    """Device bytes of a prepared block's SEQ/QUAL encode, its match
    trials' SEQ included (streams_torch.encode_bytes): what a window's
    byte budget counts."""
    jobs, v5 = pre[0], pre[6]
    counts = jobs["SEQ"][3]
    if not (counts > 0).any():
        return 0
    depths = [jobs["QUAL"][1].depth] + [jobs["SEQ"][1].depth] * (
        1 + len((v5 or {}).get("trials", ())))
    return streams_torch.encode_bytes(pad_steps(int(counts.max())),
                                      cfg.lanes, depths)


def seq_qual_args(pre, cfg: CodecConfig, raw_args=None) -> tuple:
    """The arguments, but the device, of streams_torch.encode_seq_qual_raw
    (and seq_qual_jobs) for a prepared block that holds records; raw_args:
    a match trial's instead of the block's own."""
    jobs, _, minq, _, ll_mat, own, _ = pre
    return (jobs["SEQ"][1], jobs["QUAL"][1], *(raw_args or own), cfg.lanes,
            _BASE_TO_CODE_DEV, minq, ll_mat, jobs["SEQ"][3])


def _empty_stream(counts) -> EncodedStream:
    c64 = np.asarray(counts).astype(np.int64)
    return EncodedStream(c64, np.zeros_like(c64),
                         np.zeros((len(c64), 0), dtype=np.uint8))


def _sq_jobs(pre, cfg: CodecConfig, device, alt=None, mflag=None,
             only: tuple = ("SEQ", "QUAL")):
    """A prepared block's SEQ/QUAL coder jobs (streams_torch.seq_qual_jobs
    from its raw bytes, or host_jobs from its host-packed lanes); alt and
    mflag: a match trial's rewritten SEQ and flags."""
    jobs = pre[0]
    if pre[5] is not None:
        return streams_torch.seq_qual_jobs(*seq_qual_args(pre, cfg, alt),
                                           device, mflag, only)
    return streams_torch.host_jobs(
        jobs["SEQ"][1], jobs["QUAL"][1],
        jobs["SEQ"][2] if alt is None else alt, jobs["QUAL"][2], pre[4],
        jobs["SEQ"][3], device, mflag, only)


def _window_jobs(pres, cfg: CodecConfig, device):
    """Every coded stream of a window of prepared blocks as
    streams_torch.encode_window groups, one Kernel E launch each, its
    inputs made on the device as the caller asks for them: QUAL and
    SEQ first, the longest chains, over the blocks that hold bases; then
    per threshold each match trial's SEQ and MATCH (named SEQ@t and
    MATCH@t) over the blocks with that trial; then each aux stream over
    the blocks where it codes a step."""
    based = [b for b, pre in enumerate(pres) if (pre[0]["SEQ"][3] > 0).any()]
    yield from streams_torch.seq_qual_groups(
        (b, pres[b][0]["SEQ"][3], _sq_jobs(pres[b], cfg, device))
        for b in based)
    for t in M.THRESHOLDS:
        trials = [(b, tr) for b in based
                  for tr in (pres[b][6] or {}).get("trials", ())
                  if tr[0] == t]
        yield from streams_torch.seq_qual_groups(
            ((b, pres[b][0]["SEQ"][3],
              _sq_jobs(pres[b], cfg, device, alt, mflag, ("SEQ",)))
             for b, (_, alt, _, _, mflag) in trials), ("SEQ",),
            {"SEQ": f"SEQ@{t}"})
        entries = []
        for b, (_, _, msyms, mcounts, _) in trials:
            item = streams_torch.stream_inputs("byte", cfg.bytes_, msyms,
                                               mcounts, device)
            if item is not None:
                entries.append((b, cfg.bytes_, item, mcounts))
        yield from streams_torch.by_geom(f"MATCH@{t}", "byte", entries)
    for name in streams_for(cfg.fmt):
        if name in ("SEQ", "QUAL"):
            continue  # SEQ/QUAL above
        entries = []
        for b, pre in enumerate(pres):
            kind, geom, syms, counts, _pos, _reset = pre[0][name]
            if syms.shape[0] == 0:
                continue  # an all-empty stream codes nothing
            item = streams_torch.stream_inputs(kind, geom, syms, counts,
                                               device)
            if item is not None:
                entries.append((b, geom, item, counts))
        yield from streams_torch.by_geom(name, pres[0][0][name][0], entries)


def _coder_jobs(pre, cfg: CodecConfig, device):
    """Every coded stream of one prepared block as (name, kind, geom,
    EncIn, counts), in _window_jobs' order."""
    for name, kind, geom, members in _window_jobs([pre], cfg, device):
        (_, item, counts), = members
        yield name, kind, geom, item, counts


def _coded_stream(coded: dict, name: str, counts) -> EncodedStream:
    if name not in coded:  # byte-identical to coding zero steps
        return _empty_stream(counts)
    payload, lens = coded[name]
    return EncodedStream(np.asarray(counts).astype(np.int64), lens, payload)


def encode_prepared_blocks(pres, cfg: CodecConfig, device) -> list:
    """Device half of a window's encode: code every stream of the
    prepared blocks on ``device``, each stream once over the window
    (streams_torch.encode_window), and assemble each EncodedBlock. A v5
    block's match trials are coded beside the rest; the smallest SEQ +
    MATCH total wins, the plain SEQ first and then the trials in
    threshold order, a trial only when strictly smaller (flags bit0
    records the choice). Every block's bytes are those of the block
    coded alone."""
    coded = streams_torch.encode_window(_window_jobs(pres, cfg, device),
                                        device)
    with trace("sfq.encode.assemble"):
        per = [{} for _ in pres]
        for (b, name), v in coded.items():
            per[b][name] = v
        return [_assemble(pre, per[b], cfg) for b, pre in enumerate(pres)]


def encode_prepared_block(pre, cfg: CodecConfig, device) -> EncodedBlock:
    """Device half of a block encode: encode_prepared_blocks' one-block
    case."""
    return encode_prepared_blocks([pre], cfg, device)[0]


def _assemble(pre, coded: dict, cfg: CodecConfig) -> EncodedBlock:
    jobs, n, minq, qual_depth, _, _, v5 = pre
    streams = {name: _coded_stream(coded, name, jobs[name][3])
               for name in streams_for(cfg.fmt)}
    flags = 0
    if v5 is not None:
        best = int(streams["SEQ"].lane_lens.sum())
        for t, _, _, mcounts, _ in v5["trials"]:
            seq = _coded_stream(coded, f"SEQ@{t}", jobs["SEQ"][3])
            match = _coded_stream(coded, f"MATCH@{t}", mcounts)
            total = int(seq.lane_lens.sum()) + int(match.lane_lens.sum())
            if total < best:
                best = total
                flags = MATCH_USED
                streams["SEQ"], streams["MATCH"] = seq, match
        if v5["qual_nodelta"]:
            flags |= QUAL_NODELTA
    return EncodedBlock(n, minq, qual_depth, streams, flags=flags,
                        seq_order=(v5 or {}).get("seq_order", 0))


def _aux_streams(cfg: CodecConfig) -> tuple:
    """(name, kind, geom) of the streams a block decodes on the host's
    behalf before SEQ and QUAL (MATCH only where MATCH_USED is set)."""
    return (("LEN", "byte", cfg.bytes_), ("FLAG", "flag", cfg.flags),
            ("IDD", "byte", cfg.bytes_), ("IDX", "byte", cfg.bytes_),
            ("SEQX", "byte", cfg.bytes_), ("MATCH", "byte", cfg.bytes_))


def decode_blocks_device(blocks, cfg: CodecConfig, device) -> list:
    """Device half of a window's decode: entropy-decode every stream of
    the blocks on ``device``, each stream with one Kernel D launch over
    the window, and lane-unpack SEQ/QUAL to record-major byte buffers.
    Returns per block an opaque intermediate for decode_block_finish (the
    host half: ID chain decode, v5 match reconstruction, SEQX patch,
    FASTQ assembly), None for a block without records."""
    W, Wa = cfg.lanes, cfg.aux_lanes
    live = [b for b, blk in enumerate(blocks) if blk.num_records]
    match_used = {b: cfg.fmt >= 5 and bool(blocks[b].flags & MATCH_USED)
                  for b in live}

    # 1. the aux halves: every aux stream of the window's blocks in one
    # launch on its own CUDA stream; then QUAL once LEN's lengths give its
    # pos/reset, and SEQ once the MATCH stream of a block with MATCH_USED
    # gives its match-span flags
    ss = streams_torch.StreamSet(device)
    counts = {}
    for name, kind, geom in _aux_streams(cfg):
        keys, items = [], []
        for b in live:
            if name == "MATCH" and not match_used[b]:
                continue
            n, es = blocks[b].num_records, blocks[b].streams[name]
            c = (3 * ((n - np.arange(Wa) + Wa - 1) // Wa) if name == "FLAG"
                 else es.sym_counts)
            counts[b, name] = c
            keys.append((b, name))
            items.append((es.payload, es.lane_lens, c,
                          int(np.asarray(c).max()) if len(c) else 0, None,
                          None))
        if keys:
            ss.decode_blocks(name, keys, kind, geom, items)

    def lanes(b, name):
        with trace("sfq.decode.lanes"):
            c = counts[b, name]
            syms = ss.symbols((b, name))
            if syms.size:  # one blocked transpose, then zero-copy row views
                rows = native.transpose_mat(np.ascontiguousarray(syms))
                return [rows[w, : c[w]] for w in range(len(c))]
            return [np.zeros(0, dtype=np.uint8) for _ in range(len(c))]

    prev_step = Wa if cfg.fmt >= 3 else 1  # delta baseline (frozen/fmt)

    # 2. lengths (each waits for LEN's stream only)
    with trace("sfq.decode.lanes"):
        lengths = {b: native.lens_decode(lanes(b, "LEN"),
                                         blocks[b].num_records, Wa,
                                         prev_step) for b in live}

    # 3. seq + qual -> record-major flat byte buffers, in runs of blocks
    # within the device-byte budget (a window's run unless its blocks are
    # long); on return every stream of the window has been decoded
    m_arrs: dict = {}
    args, mflags, starts, host, sizes = [], [], [], [], []
    with trace("sfq.decode.lanes"):
        for b in live:
            blk = blocks[b]
            n = blk.num_records
            rec_starts = np.zeros(n, dtype=np.int64)
            rec_starts[1:] = np.cumsum(lengths[b][:-1])
            total = int(lengths[b].sum())
            ll_mat = _lane_lengths_matrix(lengths[b], W)
            scounts = ll_mat.sum(axis=0)
            S = int(scounts.max()) if scounts.size else 0
            sgeom = (replace(cfg.seq, order=blk.seq_order)
                     if (cfg.fmt >= 5 and blk.seq_order) else cfg.seq)
            qgeom = replace(cfg.qual, depth=blk.qual_depth,
                            delta_bits=0 if (blk.flags & QUAL_NODELTA)
                            else cfg.qual.delta_bits)
            seq_s, qs = blk.streams["SEQ"], blk.streams["QUAL"]
            # decode_seq_qual_raw_blocks' per-block arguments, in its order
            args.append((sgeom, seq_s.payload, seq_s.lane_lens, qs.payload,
                         qs.lane_lens, ll_mat, scounts, rec_starts, lengths[b],
                         total, qgeom, blk.minq))
            mflags.append(partial(_seq_mflag, b, lanes, lengths[b], W, Wa, S,
                                  m_arrs) if match_used[b] else None)
            starts.append(rec_starts)
            # seq + qual bytes, at most the raw span: such a block unpacks on
            # the host, as it packed there
            host.append(2 * total >= _MAX_SPAN)
            sizes.append(streams_torch.decode_bytes(pad_steps(S), W))
        runs = streams_torch.split_by_bytes(
            sizes, streams_torch.device_budget(device)) if live else [[]]
    seq_qual = []
    for run in runs:
        seq_qual += streams_torch.decode_seq_qual_raw_blocks(
            *([args[i][k] for i in run] for k in range(12)),
            _CODE_TO_BASE_FULL, device, streams=ss,
            seq_mflags=[mflags[i] for i in run],
            host_unpack=[host[i] for i in run])

    # 4. flags (implicit counts: 3 per record), back to record order; ID
    # delta/exception streams (chain decode is in the finish half) and
    # seq exceptions (parsed + patched in C++ in the finish half)
    inters: list = [None] * len(blocks)
    with trace("sfq.decode.lanes"):
        for i, b in enumerate(live):
            n = blocks[b].num_records
            flags = native.flags_reorder(np.concatenate(lanes(b, "FLAG")),
                                         n, Wa)
            idd_lanes, idx_lanes, sx_lanes = (lanes(b, k)
                                              for k in ("IDD", "IDX", "SEQX"))
            inters[b] = (n, prev_step, lengths[b], flags, idd_lanes, idx_lanes,
                         sx_lanes, starts[i], *seq_qual[i], m_arrs.get(b))
    return inters


def _seq_mflag(b, lanes, lengths, W: int, Wa: int, S: int, m_arrs: dict):
    """Block b's parsed MATCH descriptors (record-sorted recs, refs,
    orients, vs), kept in m_arrs -> its SEQ [S, W] match-span flags."""
    with trace("sfq.decode.match_flags"):
        m_arrs[b] = m_arr = native.match_parse(lanes(b, "MATCH"), Wa,
                                               len(lengths))
        los, his = _match_span_bounds(m_arr, lengths)
        return native.match_mflag(m_arr[0], los, his, lengths, W, S)


def _pos_reset_host(ll_mat: np.ndarray):
    """(S, pos, reset [S, W]) of a block's SEQ/QUAL lanes, on the host."""
    S = int(ll_mat.sum(axis=0).max()) if ll_mat.size else 0
    return (S, *streams_np.build_pos_reset(ll_mat, S))


def encode_prepared_block_oracle(pre, cfg: CodecConfig) -> EncodedBlock:
    """encode_prepared_block on the NumPy oracle: every stream of a block
    prepared with ``host_pack`` coded by ops/streams_np, SEQ and QUAL
    (and each match trial's SEQ) with host pos/reset, the aux streams and
    MATCH without; the block assembled as on the device."""
    jobs, _, _, _, ll_mat, raw_args, v5 = pre
    if raw_args is not None:
        raise ValueError("the oracle codes blocks packed on the host")
    _, pos, reset = _pos_reset_host(ll_mat)
    coded = {}
    for name in streams_for(cfg.fmt):
        kind, geom, syms, counts, _, _ = jobs[name]
        if syms.shape[0]:  # else byte-identical to coding zero steps
            per_read = name in ("SEQ", "QUAL")
            coded[name] = streams_np.encode_stream(
                kind, geom, syms, counts, pos=pos if per_read else None,
                reset=reset if per_read else None)
    kind, geom, _, counts, _, _ = jobs["SEQ"]
    for t, alt, msyms, mcounts, mflag in (v5 or {}).get("trials", ()):
        coded[f"SEQ@{t}"] = streams_np.encode_stream(
            kind, geom, alt, counts, pos=pos, reset=reset, mflag=mflag)
        coded[f"MATCH@{t}"] = streams_np.encode_stream(
            "byte", cfg.bytes_, msyms, mcounts)
    return _assemble(pre, coded, cfg)


def decode_block_oracle(blk: EncodedBlock, cfg: CodecConfig):
    """decode_block_device on the NumPy oracle: every stream of the block
    decoded by ops/streams_np (SEQ and QUAL with host pos/reset, SEQ with
    the match-span flags of a MATCH_USED block) and SEQ/QUAL unpacked on
    the host; the intermediate for decode_block_finish, None for a block
    without records."""
    n = blk.num_records
    if n == 0:
        return None
    W, Wa = cfg.lanes, cfg.aux_lanes

    def lanes(name, kind="byte", geom=None, counts=None):
        es = blk.streams[name]
        c = es.sym_counts if counts is None else counts
        S = int(np.asarray(c).max()) if len(c) else 0
        syms = streams_np.decode_stream(kind, geom or cfg.bytes_,
                                        es.payload, es.lane_lens, c, S)
        return [syms[: c[w], w].astype(np.uint8) for w in range(len(c))]

    prev_step = Wa if cfg.fmt >= 3 else 1  # delta baseline (frozen/fmt)
    lengths = native.lens_decode(lanes("LEN"), n, Wa, prev_step)
    fcounts = 3 * ((n - np.arange(Wa) + Wa - 1) // Wa)
    flags = native.flags_reorder(
        np.concatenate(lanes("FLAG", "flag", cfg.flags, fcounts)), n, Wa)
    ll_mat = _lane_lengths_matrix(lengths, W)
    S, pos, reset = _pos_reset_host(ll_mat)
    rec_starts = np.zeros(n, dtype=np.int64)
    rec_starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    m_arr = mflag = None
    if cfg.fmt >= 5 and blk.flags & MATCH_USED:
        m_arr = native.match_parse(lanes("MATCH"), Wa, n)
        los, his = _match_span_bounds(m_arr, lengths)
        mflag = native.match_mflag(m_arr[0], los, his, lengths, W, S)
    sgeom = (replace(cfg.seq, order=blk.seq_order)
             if (cfg.fmt >= 5 and blk.seq_order) else cfg.seq)
    qgeom = replace(cfg.qual, depth=blk.qual_depth,
                    delta_bits=0 if (blk.flags & QUAL_NODELTA)
                    else cfg.qual.delta_bits)
    scounts = ll_mat.sum(axis=0)
    sq = {}
    for name, kind, geom, m in (("SEQ", "seq", sgeom, mflag),
                                ("QUAL", "qual", qgeom, None)):
        es = blk.streams[name]
        sq[name] = streams_np.decode_stream(
            kind, geom, es.payload, es.lane_lens, scounts, S, pos=pos,
            reset=reset, mflag=m).astype(np.uint8)
    seq_bytes = native.unpack_lanes(sq["SEQ"], lengths, W, rec_starts, total,
                                    map256=_CODE_TO_BASE_FULL)[:total]
    qual_bytes = native.unpack_lanes(sq["QUAL"], lengths, W, rec_starts,
                                     total, bias=blk.minq)[:total]
    return (n, prev_step, lengths, flags, *(lanes(k) for k in
                                            ("IDD", "IDX", "SEQX")),
            rec_starts, seq_bytes, qual_bytes, m_arr)


def decode_block_device(blk: EncodedBlock, cfg: CodecConfig, device):
    """Device half of a block decode: decode_blocks_device's one-block
    case."""
    return decode_blocks_device([blk], cfg, device)[0]


def decode_block_finish(inter, cfg: CodecConfig,
                        call: int | None = None) -> memoryview | bytes:
    """Host half of a block decode: ID chain decode, v5 match
    reconstruction, SEQX patch, FASTQ assembly. Returns a bytes-like
    (memoryview, zero-copy). ``call``: the api call id its span takes
    (it runs on a pool's thread)."""
    with trace("sfq.decode.finish", call=call):
        if inter is None:
            return b""
        (n, prev_step, lengths, flags, idd_lanes, idx_lanes, sx_lanes,
         rec_starts, seq_bytes, qual_bytes, m_arr) = inter
        if m_arr is not None:  # undo the e-transform, refs before dependents
            seq_bytes = native.match_reconstruct_arrays(seq_bytes, rec_starts,
                                                        lengths, m_arr)
        ida, ioff, ilen, pla, poff, plen = native.ids_decode(
            n, cfg.aux_lanes, flags, idd_lanes, idx_lanes, prev_step)
        # SEQX exception runs are patched into the assembled output's seq
        # fields, so seq/qual stay read-only views
        return native.fastq_assemble(
            n, ida, ioff, ilen,
            np.ascontiguousarray(seq_bytes), rec_starts,
            np.ascontiguousarray(qual_bytes), lengths,
            pla, poff, plen, sx_lanes=sx_lanes, fmt=cfg.fmt)
