"""Tokenised/delta read-ID modeling (capability of slimfastq's recs codec,
SURVEY.md §2 "Read-ID codec": alternating text/numeric segments, numeric
deltas vs the previous record, structural changes to an exception stream).

Frozen-format note: the delta baseline depends on the container format
version (pipeline.py keys it off cfg.fmt): v1/v2 delta against the
*globally previous* record r-1 (one serial decode chain); v3+ delta
against the *aux-lane-local* previous record r-Wa, which makes each
lane's decode chain independent — native/host.cpp decodes all Wa lanes
in parallel. Both this module and native/host.cpp implement both rules;
changing either would break bit-format compatibility.

Host-side (string-shaped, cheap); the produced symbol streams are
entropy-coded on device (SURVEY.md §3.5 doctrine: hosts own parsing).
"""

from __future__ import annotations

from ..utils.bits import get_svarint, get_varint, put_svarint, put_varint

MAX_DIGITS = 18  # digit runs longer than this are treated as opaque text


def tokenize(s: bytes) -> list[tuple[bool, bytes]]:
    """Split into alternating (is_digit_run, bytes) tokens."""
    toks: list[tuple[bool, bytes]] = []
    i, n = 0, len(s)
    while i < n:
        is_d = 48 <= s[i] <= 57
        j = i + 1
        while j < n and (48 <= s[j] <= 57) == is_d:
            j += 1
        toks.append((is_d, s[i:j]))
        i = j
    return toks


def _digit_value(tok: bytes) -> int | None:
    if len(tok) > MAX_DIGITS:
        return None
    return int(tok)


def try_delta(prev: bytes, cur: bytes) -> list[int] | None:
    """If `cur` matches `prev` structurally, return the numeric deltas of its
    digit tokens; else None (=> exception path).

    Structural match: same token count; non-digit tokens byte-identical;
    digit tokens renderable from (prev format, new value): zero-padded to the
    previous width when the previous token had a leading zero, plain decimal
    otherwise.
    """
    pt, ct = tokenize(prev), tokenize(cur)
    if len(pt) != len(ct):
        return None
    deltas: list[int] = []
    for (pd, pb), (cd, cb) in zip(pt, ct):
        if pd != cd:
            return None
        if not pd:
            if pb != cb:
                return None
            continue
        pv, cv = _digit_value(pb), _digit_value(cb)
        if pv is None or cv is None:
            if pb == cb:
                deltas.append(0)  # opaque but identical: delta 0 re-renders
                continue
            return None
        if _render(pb, cv) != cb:
            return None
        deltas.append(cv - pv)
    return deltas


def _render(prev_tok: bytes, value: int) -> bytes:
    """Render a numeric token in the previous token's format."""
    if len(prev_tok) > 1 and prev_tok[0] == 48:  # leading zero => fixed width
        return b"%0*d" % (len(prev_tok), value)
    return b"%d" % value


def apply_delta(prev: bytes, deltas: list[int]) -> bytes:
    """Decoder mirror of try_delta: rebuild `cur` from prev + deltas."""
    out = bytearray()
    di = 0
    for is_d, tok in tokenize(prev):
        if not is_d:
            out += tok
        else:
            v = _digit_value(tok)
            if v is None:
                out += tok  # opaque digits: delta was 0 by construction
                di += 1
            else:
                out += _render(tok, v + deltas[di])
                di += 1
    return bytes(out)


def num_digit_tokens(s: bytes) -> int:
    return sum(1 for is_d, _ in tokenize(s) if is_d)


def encode_record_id(prev: bytes | None, cur: bytes,
                     delta_out: bytearray, exc_out: bytearray,
                     delta_bias: int = 0) -> int:
    """Encode one ID vs its lane-previous. Returns the id_exception flag bit.

    flag=0: digit-token svarint deltas appended to delta_out. In format
    v3 deltas are stored biased by -delta_bias (= aux-lane count): a
    counter incrementing by 1 per record advances by exactly Wa along a
    lane chain, so the common case stores zigzag(0). Opaque-but-identical
    digit tokens (> MAX_DIGITS) store a literal 0, which the decoder
    ignores.
    flag=1: varint(len) + raw bytes appended to exc_out.
    """
    if prev is not None:
        deltas = try_delta(prev, cur)
        if deltas is not None:
            di = 0
            for is_d, tok in tokenize(prev):
                if not is_d:
                    continue
                if len(tok) > MAX_DIGITS:   # opaque: decoder ignores
                    put_svarint(delta_out, 0)
                else:
                    put_svarint(delta_out, deltas[di] - delta_bias)
                di += 1
            return 0
    put_varint(exc_out, len(cur))
    exc_out += cur
    return 1


def decode_record_id(prev: bytes | None, flag: int,
                     delta_buf, dpos: int, exc_buf, xpos: int,
                     delta_bias: int = 0) -> tuple[bytes, int, int]:
    """Decoder mirror. Returns (id, new dpos, new xpos)."""
    if flag == 0:
        assert prev is not None
        nd = num_digit_tokens(prev)
        deltas = []
        for _ in range(nd):
            d, dpos = get_svarint(delta_buf, dpos)
            deltas.append(d + delta_bias)
        return apply_delta(prev, deltas), dpos, xpos
    ln, xpos = get_varint(exc_buf, xpos)
    cur = bytes(exc_buf[xpos:xpos + ln])
    return cur, dpos, xpos + ln
