"""The benchmark's plain reference for one container: what the format
says a file's container must hold, held against the container the
program made of it.

Every block: the header's bytes, the index, each block's framing, CRC
and place, its record count, minimum quality, QUAL tree depth, SEQ
context order and flags, as the format's rules give them from the
FASTQ. In the sampled blocks also the coded bytes: the first
``steps`` symbol-steps of every lane of QUAL, SEQ (where the block did
not take a match trial's SEQ) and LEN, coded here by the frozen coder
(reference/coder.py) from the FASTQ's own records, against the first
bytes of the program's lanes, and LEN's symbol counts. A stream with no
more steps than that is compared whole.

Nothing here comes from the program: the records are found in the
FASTQ bytes, the lane layout and the block rules are the format's.
"""

from __future__ import annotations

import numpy as np

from . import coder, container

ORDER_FALLBACK_BASES = 1 << 20  # blocks under this fall back (format v5)
_CODE = np.zeros(256, dtype=np.uint32)  # A C G T -> 0-3, the rest 0
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def fastq_records(data: bytes) -> tuple:
    """Each record's sequence offset, quality offset and length."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(buf == 10)
    if len(nl) % 4 or (len(buf) and buf[-1] != 10):
        raise ValueError("the FASTQ is not whole 4-line records")
    soff = nl[0::4] + 1
    lens = nl[1::4] - soff
    qoff = nl[2::4] + 1
    if not np.array_equal(nl[3::4] - qoff, lens):
        raise ValueError("a quality line's length differs from its read's")
    return soff, qoff, lens


def _qual_range(buf: np.ndarray, qoff, lens) -> tuple:
    """Each record's least and greatest quality byte."""
    if not len(lens):
        return lens, lens
    cuts = np.stack([qoff, qoff + lens], axis=1).reshape(-1)
    lo = np.minimum.reduceat(buf, cuts)[0::2].astype(np.int64)
    hi = np.maximum.reduceat(buf, cuts)[0::2].astype(np.int64)
    return lo, hi


def block_rules(cfg: dict, lens, qlo, qhi) -> dict:
    """What a block's head must say, from its records."""
    total = int(lens.sum())
    minq, maxq = (int(qlo.min()), int(qhi.max())) if total else (33, 33)
    qrange = maxq - minq + 1
    order = cfg["seq"]["order"]
    eff = 10 if order > 10 and total < ORDER_FALLBACK_BASES else order
    nodelta = bool(cfg["qual"]["delta_bits"]) and \
        total < ORDER_FALLBACK_BASES
    return {"records": len(lens), "minq": minq,
            "qual_depth": 6 if qrange <= 64 else (7 if qrange <= 128 else 8),
            "seq_order": eff if eff != order else 0,
            "flags": container.QUAL_NODELTA if nodelta else 0}


def _pos_reset(mat: np.ndarray, steps: int) -> tuple:
    """pos and reset [steps, W] of lanes whose records have the lengths
    ``mat`` [records a lane, W], in order."""
    Rpl, W = mat.shape
    starts = np.zeros((Rpl, W), dtype=np.int64)
    starts[1:] = np.cumsum(mat[:-1], axis=0)
    reset = np.zeros((steps, W), dtype=np.uint32)
    r, w = np.nonzero(mat > 0)
    s = starts[r, w]
    keep = s < steps
    reset[s[keep], w[keep]] = 1
    t = np.arange(steps, dtype=np.int64)[:, None]
    last = np.maximum.accumulate(np.where(reset.astype(bool), t, -1),
                                 axis=0)
    return (t - np.maximum(last, 0)).astype(np.uint32), reset


def _lane_sources(mat, offs, steps: int) -> np.ndarray:
    """For each of the first ``steps`` symbol-steps of each lane, the
    FASTQ byte it codes (-1 past the lane's records)."""
    Rpl, W = mat.shape
    starts = np.zeros((Rpl, W), dtype=np.int64)
    starts[1:] = np.cumsum(mat[:-1], axis=0)
    # each record's symbols inside the first ``steps``, lane by lane
    take = np.minimum(mat, np.maximum(steps - starts, 0)).T.ravel()
    first = np.repeat(np.cumsum(take) - take, take)
    t = np.repeat(starts.T.ravel(), take) + np.arange(int(take.sum())) \
        - first
    lane = np.repeat(np.repeat(np.arange(W), Rpl), take)
    src = np.full((steps, W), -1, dtype=np.int64)
    src[t, lane] = np.repeat((offs - starts).T.ravel(), take) + t
    return src


def _len_lanes(lens, Wa: int) -> list:
    """LEN's bytes a lane: each record's zigzag varint of its length less
    that of the record Wa before it (the record before it, for the first
    Wa records; 0 before the first)."""
    lanes = [bytearray() for _ in range(Wa)]
    ls = lens.tolist()
    for r, L in enumerate(ls):
        p = r - Wa if r >= Wa else r - 1
        d = L - (ls[p] if p >= 0 else 0)
        u = (d << 1) if d >= 0 else ((-d << 1) - 1)
        out = lanes[r % Wa]
        while u >= 0x80:
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        out.append(u)
    return lanes


def _lanes_off(got, emitted, whole: bool, lens, pay) -> int:
    """Lanes whose program bytes are not the reference's."""
    W = len(emitted)
    width = int(emitted.max()) if W else 0
    have = np.zeros((W, width), dtype=np.uint8)
    k = min(width, pay.shape[1])
    have[:, :k] = pay[:, :k]
    inside = np.arange(width)[None, :] < emitted[:, None]
    differ = ((have != got[:, :width]) & inside).any(axis=1)
    short = (lens != emitted) if whole else (lens < emitted)
    return int((differ | short).sum())


def check(data: bytes, fastq: bytes, cfg: dict, sample: list,
          steps: int = coder.STEP_BUCKET, device="cpu") -> dict:
    """Hold ``data``, the program's container of ``fastq``, to the
    format. ``sample``: the blocks whose coded bytes are compared, each
    stream's first ``steps`` symbol-steps coded on ``device``.
    Returns {"faults": [what departs, ...], "lanes": lanes compared,
    "lanes_off": lanes whose bytes depart}."""
    faults, lanes_n, lanes_off, jobs = [], 0, 0, []
    if data[:39] != container.expected_header(cfg):
        faults.append("header")
    try:
        spans = container.blocks(data)
    except container.Bad as e:
        return {"faults": faults + [f"framing: {e}"], "lanes": 0,
                "lanes_off": 0}
    buf = np.frombuffer(fastq, dtype=np.uint8)
    soff, qoff, lens = fastq_records(fastq)
    qlo, qhi = _qual_range(buf, qoff, lens)
    BR, W, Wa = cfg["block_records"], cfg["lanes"], cfg["aux_lanes"]
    want_blocks = max(1, -(-len(lens) // BR))
    if len(spans) != want_blocks:
        faults.append(f"{len(spans)} blocks, the format gives "
                      f"{want_blocks}")
    for b, span in enumerate(spans[:want_blocks]):
        sl = slice(b * BR, (b + 1) * BR)
        rule = block_rules(cfg, lens[sl], qlo[sl], qhi[sl])
        head = container.block_head(data, span)
        flags = head["flags"]
        if cfg["match"]:
            flags &= ~container.MATCH_USED
        for k, v in rule.items():
            if (flags if k == "flags" else head[k]) != v:
                faults.append(f"block {b} {k} {head[k]} != {v}")
        if b not in sample:
            continue
        try:
            streams = container.block_streams(data, span)
        except container.Bad as e:
            faults.append(f"block {b}: {e}")
            continue
        n = rule["records"]
        Rpl = -(-n // W)
        mat = np.zeros((Rpl, W), dtype=np.int64)
        mat.reshape(-1)[:n] = lens[sl]
        counts = mat.sum(axis=0)
        pos, reset = _pos_reset(mat, steps)
        mine = []  # (stream, geometry, symbols, counts, pos, reset)
        q = dict(cfg["qual"], depth=rule["qual_depth"],
                 delta_bits=0 if rule["flags"] & container.QUAL_NODELTA
                 else cfg["qual"]["delta_bits"])
        qoffs = np.zeros(Rpl * W, dtype=np.int64)
        qoffs[:n] = qoff[sl]
        src = _lane_sources(mat, qoffs.reshape(Rpl, W), steps)
        qs = np.where(src >= 0, buf[np.maximum(src, 0)].astype(np.int64)
                      - rule["minq"], 0).astype(np.uint32)
        mine.append(("QUAL", coder.Geom("qual", **q), qs, counts, pos,
                     reset))
        if not head["flags"] & container.MATCH_USED:
            order = rule["seq_order"] or cfg["seq"]["order"]
            soffs = np.zeros(Rpl * W, dtype=np.int64)
            soffs[:n] = soff[sl]
            src = _lane_sources(mat, soffs.reshape(Rpl, W), steps)
            ss = np.where(src >= 0, _CODE[buf[np.maximum(src, 0)]], 0)
            mine.append(("SEQ", coder.Geom("seq", **dict(
                cfg["seq"], order=order)), ss.astype(np.uint32), counts,
                pos, reset))
        lanes = _len_lanes(lens[sl], Wa)
        lcounts = np.array([len(x) for x in lanes], dtype=np.int64)
        if not np.array_equal(streams["LEN"][0], lcounts):
            faults.append(f"block {b} LEN symbol counts")
        ls = np.zeros((steps, Wa), dtype=np.uint32)
        for w, x in enumerate(lanes):
            row = np.frombuffer(bytes(x[:steps]), dtype=np.uint8)
            ls[:len(row), w] = row
        mine.append(("LEN", coder.Geom("byte", **cfg["bytes"]), ls, lcounts,
                     None, None))
        jobs += [j + (streams,) for j in mine]
    coded = coder.encode_streams([j[1:6] for j in jobs], steps, device)
    for (name, _, _, cnt, _, _, streams), (got, emitted, whole) in zip(
            jobs, coded):
        _, plens, pay = streams[name]
        lanes_n += len(cnt)
        lanes_off += _lanes_off(got, emitted, whole, plens, pay)
    return {"faults": faults, "lanes": lanes_n, "lanes_off": lanes_off}
