"""Small host-side byte utilities: LEB128 varints + zigzag."""

from __future__ import annotations


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else (v << 1)


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def put_varint(out: bytearray, v: int) -> None:
    assert v >= 0
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


MAX_VARINT_BYTES = 10  # bounds any u64; mirrors native/host.cpp get_varint


def get_varint(buf, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    end = len(buf)
    for _ in range(MAX_VARINT_BYTES):
        if pos >= end:
            raise ValueError("truncated varint (corrupt stream)")
        b = int(buf[pos])  # int() guards numpy uint8 buffers: a raw
        pos += 1           # uint8 would wrap in the << shift below
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7
    raise ValueError("overlong varint (corrupt stream)")


def put_svarint(out: bytearray, v: int) -> None:
    put_varint(out, zigzag(v))


def get_svarint(buf, pos: int) -> tuple[int, int]:
    u, pos = get_varint(buf, pos)
    return unzigzag(u), pos


# ---------------------------------------------------------------------------
# Vectorised varint arrays (NumPy). Byte-identical to the scalar loops
# above (canonical LEB128); used by the container lane tables, which were
# the last per-element Python loops on the block hot path (~1k lanes x 2
# arrays per stream per block).
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402  (host-side utility; numpy is a core dep)


def zigzag_arr(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).view(np.uint64)


def unzigzag_arr(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> 1).view(np.int64)) ^ -((u & 1).view(np.int64))


def put_varint_arr(u: np.ndarray) -> np.ndarray:
    """Concatenated canonical LEB128 encodings of a uint64 array."""
    u = np.ascontiguousarray(u, dtype=np.uint64)
    n = len(u)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    nb = np.ones(n, dtype=np.int64)
    x = u >> np.uint64(7)
    while x.any():
        nb += (x > 0)
        x >>= np.uint64(7)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(nb[:-1], out=offs[1:])
    total = int(offs[-1] + nb[-1])
    out = np.zeros(total, dtype=np.uint8)
    for k in range(int(nb.max())):
        m = nb > k
        b = ((u[m] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        out[offs[m] + k] = b | np.where(nb[m] > k + 1, 0x80, 0) \
            .astype(np.uint8)
    return out


def get_varint_arr(buf, pos: int, n: int) -> tuple[np.ndarray, int]:
    """Decode n varints starting at pos. Returns (uint64 array, new pos).
    Raises ValueError on truncation or overlong (>10-byte) values."""
    if n == 0:
        return np.zeros(0, dtype=np.uint64), pos
    a = np.frombuffer(buf, dtype=np.uint8)
    window = a[pos: pos + MAX_VARINT_BYTES * n]
    terms = np.flatnonzero((window & 0x80) == 0)
    if len(terms) < n:
        raise ValueError("truncated varint array (corrupt stream)")
    terms = terms[:n]
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = terms[:-1] + 1
    widths = terms - starts + 1
    if int(widths.max()) > MAX_VARINT_BYTES:
        raise ValueError("overlong varint (corrupt stream)")
    vals = np.zeros(n, dtype=np.uint64)
    for k in range(int(widths.max())):
        m = widths > k
        vals[m] |= (window[starts[m] + k].astype(np.uint64)
                    & np.uint64(0x7F)) << np.uint64(7 * k)
    return vals, pos + int(terms[-1]) + 1
