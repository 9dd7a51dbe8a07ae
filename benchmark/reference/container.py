"""The sfq container (format v5) read in plain Python and NumPy, for the
benchmark's check: header, blocks and index, every CRC, and each
block's streams as (symbol counts, lane lengths, lane payloads).

Layout (little-endian): header ``SFQT`` | u16 version | u8 level | u8 0
| u32 lanes | u32 aux_lanes | u32 block_records | 12 geometry bytes
(qual depth, q2_bits, delta_bits, pos_bits, pos_shift, rate; seq order,
rate; byte order, rate; flag hist_bits, rate) | qual rate_lo, seq
rate_lo | seq match_bits | u32 crc32. A block: u32 crc32(body) | u32
body length | body: u32 records | u8 minq | u8 qual depth | u8 flags |
u8 seq order, then each stream in the order LEN FLAG IDD IDX SEQX SEQ
QUAL MATCH: its symbol counts (not for FLAG, SEQ, QUAL) and lane
lengths, each a varint count then zigzag varint deltas, then the lanes'
payloads back to back. The index: u64 block offsets | u32 blocks |
u32 crc32 | ``SFQE``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

STREAMS = ("LEN", "FLAG", "IDD", "IDX", "SEQX", "SEQ", "QUAL", "MATCH")
IMPLICIT = ("FLAG", "SEQ", "QUAL")
MATCH_USED, QUAL_NODELTA = 1, 2


class Bad(ValueError):
    """The container departs from the format."""


def expected_header(cfg: dict) -> bytes:
    """The 39 header bytes a configuration's containers start with."""
    q, s, b, f = cfg["qual"], cfg["seq"], cfg["bytes"], cfg["flags"]
    hdr = b"SFQT" + struct.pack(
        "<HBBIII", cfg["format_version"], cfg["level"], 0, cfg["lanes"],
        cfg["aux_lanes"], cfg["block_records"])
    hdr += bytes([q["depth"], q["q2_bits"], q["delta_bits"], q["pos_bits"],
                  q["pos_shift"], q["rate"], s["order"], s["rate"],
                  b["order"], b["rate"], f["hist_bits"], f["rate"],
                  q["rate_lo"], s["rate_lo"], s["match_bits"]])
    return hdr + struct.pack("<I", zlib.crc32(hdr))


def _varint(buf, pos: int) -> tuple:
    v = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise Bad("varint runs past the block")
        byte = buf[pos]
        pos += 1
        v |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return v, pos
        shift += 7


def _array(buf, pos: int) -> tuple:
    n, pos = _varint(buf, pos)
    if n > 1 << 20:
        raise Bad(f"lane array of {n}")
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        u, pos = _varint(buf, pos)
        out[i] = (u >> 1) ^ -(u & 1)
    return np.cumsum(out), pos


def blocks(data: bytes) -> list:
    """Each block's body span (start, end) in ``data``, after checking
    the index, every block's framing and CRC, and that the blocks follow
    the header back to back."""
    if len(data) < 39 + 16 or data[-4:] != b"SFQE":
        raise Bad("no end magic")
    n, crc = struct.unpack_from("<II", data, len(data) - 12)
    ix0 = len(data) - 12 - 8 * n
    if ix0 < 39 or zlib.crc32(data[ix0:len(data) - 8]) != crc:
        raise Bad("index CRC")
    offsets = struct.unpack_from(f"<{n}Q", data, ix0)
    spans, at = [], 39
    for off in offsets:
        if off != at:
            raise Bad(f"block at {off}, expected {at}")
        bcrc, blen = struct.unpack_from("<II", data, off)
        body = (off + 8, off + 8 + blen)
        if body[1] > ix0 or zlib.crc32(data[body[0]:body[1]]) != bcrc:
            raise Bad(f"block {len(spans)} CRC or length")
        spans.append(body)
        at = body[1]
    if at != ix0:
        raise Bad("bytes between the last block and the index")
    return spans


def block_head(data: bytes, span) -> dict:
    n, minq, qd, flags, order = struct.unpack_from("<IBBBB", data, span[0])
    return {"records": n, "minq": minq, "qual_depth": qd, "flags": flags,
            "seq_order": order}


def block_streams(data: bytes, span) -> dict:
    """{stream: (counts or None, lane lengths, payload [W, max] uint8)}."""
    buf = memoryview(data)[span[0]:span[1]]
    pos, out = 8, {}
    for name in STREAMS:
        counts = None
        if name not in IMPLICIT:
            counts, pos = _array(buf, pos)
        lens, pos = _array(buf, pos)
        if (lens < 0).any() or pos + int(lens.sum()) > len(buf):
            raise Bad(f"{name} lane lengths")
        width = int(lens.max()) if len(lens) else 0
        pay = np.zeros((len(lens), width), dtype=np.uint8)
        flat = np.frombuffer(buf, dtype=np.uint8, count=int(lens.sum()),
                             offset=pos)
        pay[np.arange(width)[None, :] < lens[:, None]] = flat
        pos += int(lens.sum())
        out[name] = (counts, lens, pay)
    if pos != len(buf):
        raise Bad("block body longer than its streams")
    return out
