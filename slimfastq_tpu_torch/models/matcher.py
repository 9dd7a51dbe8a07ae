"""Long-range read-match modeling (format v5) — normative NumPy matcher.

High-coverage FASTQ (multiple reads covering the same genome span) has
verbatim cross-read structure a per-symbol context model cannot see; it is
the one axis where LZ77 codecs beat context modeling (BASELINE.md xz-gap
decomposition; round-3 VERDICT item #4). Format v5 captures it with a
block-local read-match stream:

* For each read r the encoder may pick one earlier read `ref` in the same
  block plus an orientation and shift such that `ref` predicts a span of
  r's bases. The per-read descriptor goes to the MATCH byte stream; the
  read's 2-bit codes are replaced over the span by the *e-transform*
      e[i] = (c[i] - pred[i]) & 3
  so matched spans become near-zero runs the existing order-k SEQ model
  codes at ~H(p_err) bits/base. Mismatches are just nonzero e symbols —
  no exception stream, no SEQ kernel/layout change at all.
* Decode reconstructs hosts-side after the device SEQ decode:
  c[i] = (e[i] + pred[i]) & 3, walking records in order (ref < r).

Prediction rule (FROZEN, format v5):
  c = 2-bit codes with non-ACGT coded as 0 (exactly the coded SEQ symbols,
  which is what decode reconstructs — N letters are patched later by SEQX).
  Descriptor (ref, orient, v), L = len(read), Lref = len(ref):
    orient 0: pred[i] = c_ref[i + v]          span [max(0,-v), min(L, Lref-v))
    orient 1: pred[i] = 3 - c_ref[L-1+v - i]  span [max(0, L+v-Lref), min(L, L+v))
  (orient 1 is the reverse-complement alignment expressed in fwd coords.)

MATCH stream (FROZEN, format v5): aux-lane-local like SEQX (lane = r % Wa,
ordinal = r // Wa). Per matched read, in record order within the lane:
    varint(ordinal - prev_ordinal)   [prev starts at -1]
    varint(r - ref)                  [>= 1]
    varint(zigzag(v) * 2 + orient)

Encoder match search (shared policy — the C++ twin in native/host.cpp must
reproduce it bit-for-bit; tests pin equality):
  * K = 16-base k-mers packed 2 bits MSB-first; a position is *sampled*
    iff splitmix64_mix(kmer) & SAMPLE_MASK == 0 (content-keyed sampling:
    index and query sample identical positions, so arbitrary shifts are
    found). The mask is an encoder knob (see sample_mask below).
  * Reads are processed in chunks of MATCH_CHUNK records; candidates come
    only from earlier chunks (lets the C++ matcher parallelise queries
    within a chunk; decode does not care).
  * The index maps kmer -> up to MAX_CAND (ref, pos) entries of *forward*
    read codes, inserted in (ref asc, pos asc) order, never evicted.
  * A query read looks up its sampled forward kmers (orient 0) and the
    sampled kmers of its reverse-complement codes (orient 1). Each hit
    implies an alignment (ref, orient, shift); each distinct alignment is
    scored once: score = span_len - MM_PENALTY * mismatches, span >= K.
  * Best candidate by the total order (score, ref, -orient, -zigzag(v))
    maximised; accepted iff score >= min_score.

Match-context family (FROZEN, format v5 — config.SeqGeom.match_bits):
when the block's SEQ geometry carries match_bits > 0, positions inside
an accepted match span are coded under a dedicated context family
    ctx = tree_ctx + (h & (2^match_bits - 1))
where h is the SEQ context's rolling 2-bit coded-symbol history (which
holds e-symbols there). Positions outside spans use the normal order-k
prefix-tree rule; h rolls over ALL coded symbols either way. Routing
e-spans through the genome tree instead cost 8-16% of the SEQ stream in
span-entry and post-mismatch context pollution (tools/probe_matchctx.py:
novaseq SEQ -15.7%, illumina -49% at threshold 48).

The minimum-score threshold is an ENCODER knob (like an LZ matcher's
effort): it never affects decodability. encode_block trial-codes the SEQ
stream for THRESHOLDS plus plain and keeps the smallest total
(seq + match bytes), so no corpus can regress by more than the per-block
flag bit (measured: tools/probe_matches.py — novaseq +11.6..12.0%,
illumina +1.6%, lowcov +5.2%; plain wins where context modeling already
beats LZ).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.bits import get_varint, put_varint

K = 16
MAX_CAND = 16
MM_PENALTY = 8
MATCH_CHUNK = 1024
THRESHOLDS = (48, 96)    # encoder trial min_scores (low -> high)
ORDER_FALLBACK_BASES = 1 << 20

U64 = np.uint64
_B2C0 = np.zeros(256, dtype=np.uint8)   # non-ACGT -> 0 (coded codes)
for _i, _b in enumerate(b"ACGT"):
    _B2C0[_b] = _i


def sample_mask() -> int:
    """The sampling mask: a position is sampled iff mix(kmer) & mask == 0
    (content-keyed: index and query sample identical positions). ENCODER
    policy, not bit format — decode reads explicit descriptors. Default
    15 (1/16) since round 5: vs 7 (1/8) it costs +0.16..0.23% container
    size on the probe corpora and cuts match_find ~38%
    (tools/probe_sample_mask.py re-measures). SFQ_MATCH_SAMPLE_MASK
    overrides it for that probe; it is read here, at each call, and by
    nothing else: the oracle (find_matches) and the native twin's wrapper
    (native.match_find_arrays) both take the mask from here."""
    return int(os.environ.get("SFQ_MATCH_SAMPLE_MASK", "15"))


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (uint64 wrap-around, identical in C++)."""
    x = x.astype(U64, copy=True)
    x ^= x >> U64(30)
    x *= U64(0xBF58476D1CE4E5B9)
    x ^= x >> U64(27)
    x *= U64(0x94D049BB133111EB)
    x ^= x >> U64(31)
    return x


def _kmers(c: np.ndarray) -> np.ndarray:
    """Packed K-mers of a 2-bit code array, MSB-first: uint64[L-K+1]."""
    L = len(c)
    if L < K:
        return np.empty(0, dtype=U64)
    v = c.astype(U64)
    out = np.zeros(L - K + 1, dtype=U64)
    acc = U64(0)
    for j in range(K):
        acc = (acc << U64(2)) | v[j]
    out[0] = acc
    mask = U64((1 << (2 * K)) - 1)
    for i in range(1, L - K + 1):
        acc = ((acc << U64(2)) | v[i + K - 1]) & mask
        out[i] = acc
    return out


def _sampled(km: np.ndarray, mask: int | None = None) -> np.ndarray:
    """Positions whose kmer is content-sampled under ``mask``
    (sample_mask() when None)."""
    if km.size == 0:
        return np.empty(0, dtype=np.int64)
    if mask is None:
        mask = sample_mask()
    return np.flatnonzero((_mix64(km) & U64(mask)) == U64(0))


def span_bounds(orient: int, v: int, L: int, Lref: int) -> tuple[int, int]:
    """FROZEN span rule (see module docstring)."""
    if orient == 0:
        return max(0, -v), min(L, Lref - v)
    return max(0, L + v - Lref), min(L, L + v)


def pred_span(c_ref: np.ndarray, orient: int, v: int, L: int
              ) -> tuple[int, int, np.ndarray]:
    """Predicted codes for read positions [lo, hi). Returns (lo, hi, pred)."""
    lo, hi = span_bounds(orient, v, L, len(c_ref))
    if hi <= lo:
        return lo, lo, np.empty(0, dtype=np.uint8)
    if orient == 0:
        pred = c_ref[lo + v: hi + v]
    else:
        pred = (3 - c_ref[L - 1 + v - (hi - 1): L + v - lo])[::-1]
    return lo, hi, pred.astype(np.uint8)


def find_matches(codes: list[np.ndarray]) -> list[tuple[int, int, int, int]
                                                 | None]:
    """Normative (slow) matcher. codes[r] = uint8 2-bit code array of read
    r (non-ACGT as 0). Returns per read None or (ref, orient, v, score)
    with score >= min(THRESHOLDS) left to the caller to filter."""
    n = len(codes)
    rcs = [(3 - c[::-1]).astype(np.uint8) for c in codes]
    index: dict[int, list[tuple[int, int]]] = {}
    out: list[tuple[int, int, int, int] | None] = [None] * n
    min_score = min(THRESHOLDS)
    mask = sample_mask()

    for g_lo in range(0, n, MATCH_CHUNK):
        g_hi = min(g_lo + MATCH_CHUNK, n)
        if g_lo:
            for r in range(g_lo, g_hi):
                c = codes[r]
                L = len(c)
                best = None  # (score, ref, -orient, -zz(v), v, orient)
                seen: set[tuple[int, int, int]] = set()
                for orient, arr in ((0, c), (1, rcs[r])):
                    # a hit means arr[i] ~= c_ref[i + v]; for orient 1
                    # (arr = rc(c)) this is exactly the frozen fwd-coords
                    # rule: c[i] = 3-arr[L-1-i] ~= 3-c_ref[(L-1+v)-i]
                    km = _kmers(arr)
                    for p in _sampled(km, mask):
                        for (ref, q) in index.get(int(km[p]), ()):
                            v = int(q - p)
                            key = (ref, orient, v)
                            if key in seen:
                                continue
                            seen.add(key)
                            lref = len(codes[ref])
                            lo = max(0, -v)
                            hi = min(L, lref - v)
                            if hi - lo < K:
                                continue
                            mm = int((arr[lo:hi] != codes[ref][
                                lo + v: hi + v]).sum())
                            score = (hi - lo) - MM_PENALTY * mm
                            if score < min_score:
                                continue
                            zz = (v << 1) if v >= 0 else (-v << 1) - 1
                            cand = (score, ref, -orient, -zz)
                            if best is None or cand > best[:4]:
                                best = (score, ref, -orient, -zz, v, orient)
                if best is not None:
                    out[r] = (best[1], best[5], best[4], best[0])
        # index this chunk's forward kmers
        for r in range(g_lo, g_hi):
            km = _kmers(codes[r])
            for p in _sampled(km, mask):
                lst = index.setdefault(int(km[p]), [])
                if len(lst) < MAX_CAND:
                    lst.append((r, int(p)))
    return out


def apply_e_transform(codes: list[np.ndarray],
                      matches: list[tuple[int, int, int, int] | None],
                      min_score: int) -> list[np.ndarray]:
    """Encoder side: e-codes for every read (copy-on-write), keeping only
    matches with score >= min_score."""
    out = list(codes)
    for r, m in enumerate(matches):
        if m is None or m[3] < min_score:
            continue
        ref, orient, v, _ = m
        lo, hi, pred = pred_span(codes[ref], orient, v, len(codes[r]))
        if hi <= lo:
            continue
        e = codes[r].copy()
        e[lo:hi] = (e[lo:hi] - pred) & 3
        out[r] = e
    return out


def encode_match_lanes(matches, min_score: int, n: int, Wa: int
                       ) -> list[bytearray]:
    """Build the per-aux-lane MATCH byte streams (frozen layout above)."""
    lanes = [bytearray() for _ in range(Wa)]
    prev_ord = [-1] * Wa
    for r in range(n):
        m = matches[r]
        if m is None or m[3] < min_score:
            continue
        ref, orient, v, _ = m
        w = r % Wa
        ordinal = r // Wa
        put_varint(lanes[w], ordinal - prev_ord[w])
        put_varint(lanes[w], r - ref)
        zz = (v << 1) if v >= 0 else (-v << 1) - 1
        put_varint(lanes[w], (zz << 1) | orient)
        prev_ord[w] = ordinal
    return lanes


def parse_match_lane(buf) -> list[tuple[int, int, int, int]]:
    """Parse one aux-lane MATCH stream -> (ordinal, ref_delta, orient, v)."""
    out = []
    p = 0
    ordinal = -1
    while p < len(buf):
        d, p = get_varint(buf, p)
        ordinal += d
        rd, p = get_varint(buf, p)
        tok, p = get_varint(buf, p)
        orient = tok & 1
        zz = tok >> 1
        v = (zz >> 1) if (zz & 1) == 0 else -((zz + 1) >> 1)
        out.append((ordinal, rd, orient, v))
    return out


def spans(per_read, lengths) -> list[tuple[int, int, int]]:
    """(r, lo, hi) spans for per_read[r] = (ref, orient, v) | None."""
    out = []
    for r, m in enumerate(per_read):
        if m is None:
            continue
        ref, orient, v = m[0], m[1], m[2]
        lo, hi = span_bounds(orient, v, int(lengths[r]),
                             int(lengths[ref]))
        if hi > lo:
            out.append((r, lo, hi))
    return out


def span_flags_flat(span_list, rec_starts, total: int) -> np.ndarray:
    """Record-major uint8 match flags (1 inside a span) from (r, lo, hi)
    spans — interval diff + cumsum (spans are per-read disjoint)."""
    d = np.zeros(total + 1, dtype=np.int32)
    if span_list:
        rs = np.array([int(rec_starts[r]) for (r, _lo, _hi) in span_list],
                      dtype=np.int64)
        los = np.array([lo for (_r, lo, _hi) in span_list], dtype=np.int64)
        his = np.array([hi for (_r, _lo, hi) in span_list], dtype=np.int64)
        np.add.at(d, rs + los, 1)
        np.add.at(d, rs + his, -1)
    return (np.cumsum(d[:-1]) > 0).astype(np.uint8)


def reconstruct(codes: list[np.ndarray],
                per_read: list[tuple[int, int] | None]) -> None:
    """Decoder side, in place: codes[r] currently holds e-codes; per_read[r]
    is None or (ref, orient, v). Records walk in order, so refs are already
    reconstructed (ref < r enforced by the descriptor's ref_delta >= 1)."""
    for r, m in enumerate(per_read):
        if m is None:
            continue
        ref, orient, v = m
        lo, hi, pred = pred_span(codes[ref], orient, v, len(codes[r]))
        if hi <= lo:
            continue
        codes[r][lo:hi] = (codes[r][lo:hi] + pred) & 3


def effective_seq_order(order: int, total_bases: int) -> int:
    """Shared encoder policy (format v5): small blocks cannot warm an
    order-11 table (measured — BASELINE.md round-3 compression notes), so
    blocks under ORDER_FALLBACK_BASES drop to order 10. Recorded per block
    (EncodedBlock.seq_order), so this is tunable without a format change."""
    if order > 10 and total_bases < ORDER_FALLBACK_BASES:
        return 10
    return order


def effective_qual_delta(delta_bits: int, total_quals: int) -> int:
    """Shared encoder policy (format v5): the L4 q1-q2 delta context
    ingredient quadruples the quality context space; on small blocks the
    extra cold-table cost exceeds its information gain (measured on the
    wide-alphabet longread corpus: -469 B at 90k quals, -463 B at 373k,
    +71 B at 1.5M). Blocks under ORDER_FALLBACK_BASES symbols drop it;
    recorded per block (EncodedBlock.flags QUAL_NODELTA bit)."""
    if delta_bits and total_quals < ORDER_FALLBACK_BASES:
        return 0
    return delta_bits
