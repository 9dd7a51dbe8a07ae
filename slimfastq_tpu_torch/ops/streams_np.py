"""Generic lane-stream encode/decode — NumPy oracle (the port's copy of
the JAX package's ops/streams_np.py; NumPy only).

A *stream* is a [S, W] matrix of symbols (S lockstep steps, W lanes) plus a
per-lane symbol count. Context is computed per step from a small carried
state whose update law is shared verbatim between encoder and decoder — the
determinism requirement inherited from slimfastq's mirrored save/load codecs
(SURVEY.md §1 data-flow note).

Context kinds:
  * qual: ctx = q1 | quantised(q2) << d | pos_bucket << (d + q2b)
  * seq:  ctx = previous `order` bases, rolled 2 bits per step, reset per read
  * byte: ctx = previous byte (order-1) or constant (order-0); continuous
          within a lane so the decoder never needs record boundaries
  * flag: ctx = last `hist_bits` decoded flags
"""

from __future__ import annotations

import numpy as np

from ..config import ByteGeom, FlagGeom, QualGeom, SeqGeom
from . import ranger as R

U32 = np.uint32


class QualCtx:
    def __init__(self, geom: QualGeom, W: int):
        self.g = geom
        self.a = np.zeros(W, dtype=U32)  # prev qual within read
        self.b = np.zeros(W, dtype=U32)  # prev-prev qual within read

    def step_ctx(self, t: int, pos: np.ndarray, reset: np.ndarray) -> np.ndarray:
        g = self.g
        rs = reset.astype(bool)
        self.a = np.where(rs, U32(0), self.a)
        self.b = np.where(rs, U32(0), self.b)
        ctx = self.a
        shift = g.depth
        if g.q2_bits:
            q2q = self.b >> U32(g.depth - g.q2_bits)
            ctx = ctx | (q2q << U32(shift))
            shift += g.q2_bits
        if g.delta_bits:
            diff = self.a.astype(np.int32) - self.b.astype(np.int32)
            dc = np.where(diff == 0, 0,
                          np.where((diff > 0) & (diff <= 3), 1,
                                   np.where((diff < 0) & (diff >= -3),
                                            2, 3))).astype(U32)
            ctx = ctx | (dc << U32(shift))
            shift += g.delta_bits
        if g.pos_bits:
            posb = np.minimum(pos >> U32(g.pos_shift),
                              U32((1 << g.pos_bits) - 1))
            ctx = ctx | (posb.astype(U32) << U32(shift))
        return ctx

    def advance(self, sym: np.ndarray) -> None:
        self.b = self.a
        self.a = sym.astype(U32)


class SeqCtx:
    def __init__(self, geom: SeqGeom, W: int):
        self.g = geom
        self.h = np.zeros(W, dtype=U32)
        self.mask = U32((1 << (2 * geom.order)) - 1)
        # offset[j] = (4^j - 1) / 3: start of the order-j partial-ctx region
        k = geom.order
        self.offsets = (((U32(1) << (2 * np.arange(k + 1, dtype=U32)))
                         - U32(1)) // U32(3)).astype(U32)

    def step_ctx(self, t: int, pos: np.ndarray, reset: np.ndarray,
                 mflag: np.ndarray | None = None) -> np.ndarray:
        self.h = np.where(reset.astype(bool), U32(0), self.h)
        j = np.minimum(pos.astype(np.int64), self.g.order)
        ctx = self.h + self.offsets[j]
        if self.g.match_bits and mflag is not None:
            # v5 match-context family: inside an accepted match span the
            # context is the low bits of the rolling e-symbol history
            # (frozen rule — models/matcher.py docstring)
            mctx = (U32(self.g.tree_ctx)
                    + (self.h & U32((1 << self.g.match_bits) - 1)))
            ctx = np.where(mflag.astype(bool), mctx, ctx)
        return ctx

    def advance(self, sym: np.ndarray) -> None:
        self.h = ((self.h << U32(2)) | sym.astype(U32)) & self.mask


class ByteCtx:
    def __init__(self, geom: ByteGeom, W: int):
        self.g = geom
        self.pb = np.zeros(W, dtype=U32)

    def step_ctx(self, t: int, pos=None, reset=None) -> np.ndarray:
        return self.pb if self.g.order else np.zeros_like(self.pb)

    def advance(self, sym: np.ndarray) -> None:
        self.pb = sym.astype(U32)


class FlagCtx:
    def __init__(self, geom: FlagGeom, W: int):
        self.g = geom
        self.hist = np.zeros(W, dtype=U32)
        self.mask = U32((1 << geom.hist_bits) - 1)

    def step_ctx(self, t: int, pos=None, reset=None) -> np.ndarray:
        return self.hist

    def advance(self, sym: np.ndarray) -> None:
        self.hist = ((self.hist << U32(1)) | sym.astype(U32)) & self.mask


_CTX = {"qual": QualCtx, "seq": SeqCtx, "byte": ByteCtx, "flag": FlagCtx}


def _geom_fields(geom):
    return geom.depth, geom.rate, geom.table_size, geom.sac_base, geom.num_ctx


def encode_stream(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None):
    """Encode [S, W] symbols. Returns (payload uint8[W, maxlen], lens[W]).

    Pad-coded lockstep format: all lanes code pad_steps(S) steps; steps
    beyond a lane's own count code symbol 0 in the sacrificial context.
    Lanes with zero symbols contribute no bytes. mflag ([S, W], seq
    streams only): positions inside a v5 match span (match-ctx family).
    """
    S, W = syms.shape
    syms = syms.astype(U32, copy=False)   # uint8 boundary: oracle is U32
    depth, rate, tsize, sac_base, num_ctx = _geom_fields(geom)
    Sp = R.pad_steps(S)
    counts = np.asarray(counts)
    table = R.table_init(tsize, sac_base)
    rate_lo = getattr(geom, "rate_lo", 0)
    vtable = (np.zeros(tsize, dtype=np.int32)
              if 0 < rate_lo < rate else None)
    enc = R.LaneEncoder(W, R.worst_case_bytes(Sp * depth))
    ctxer = _CTX[kind](geom, W)
    z = np.zeros(W, dtype=U32)
    for t in range(Sp):
        active = counts > t
        p_t = pos[t] if pos is not None and t < S else z
        r_t = reset[t] if reset is not None and t < S else z
        if kind == "seq":
            m_t = mflag[t] if mflag is not None and t < S else None
            ctx = ctxer.step_ctx(t, p_t, r_t, mflag=m_t)
        else:
            ctx = ctxer.step_ctx(t, p_t, r_t)
        ctx = np.where(active, ctx, U32(num_ctx))
        sym = (np.where(active, syms[t], 0).astype(U32)
               if t < S else z)
        R.encode_symbols(enc, table, ctx, sym, depth, rate, sac_base,
                         vtable=vtable, rate_lo=rate_lo)
        ctxer.advance(sym)
    enc.flush()
    lens = np.where(counts > 0, enc.ptr, 0).astype(np.int64)
    maxlen = int(lens.max()) if lens.size else 0
    return enc.out[:, :maxlen].copy(), lens


def decode_stream(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                  counts: np.ndarray, num_steps: int,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None) -> np.ndarray:
    """Decode back to uint32[S, W] symbols (0 where inactive)."""
    W = payload.shape[0]
    depth, rate, tsize, sac_base, num_ctx = _geom_fields(geom)
    S = num_steps
    Sp = R.pad_steps(S)
    counts = np.asarray(counts)
    table = R.table_init(tsize, sac_base)
    rate_lo = getattr(geom, "rate_lo", 0)
    vtable = (np.zeros(tsize, dtype=np.int32)
              if 0 < rate_lo < rate else None)
    dec = R.LaneDecoder(payload, lens)
    ctxer = _CTX[kind](geom, W)
    out = np.zeros((S, W), dtype=U32)
    z = np.zeros(W, dtype=U32)
    for t in range(Sp):
        active = counts > t
        p_t = pos[t] if pos is not None and t < S else z
        r_t = reset[t] if reset is not None and t < S else z
        if kind == "seq":
            m_t = mflag[t] if mflag is not None and t < S else None
            ctx = ctxer.step_ctx(t, p_t, r_t, mflag=m_t)
        else:
            ctx = ctxer.step_ctx(t, p_t, r_t)
        ctx = np.where(active, ctx, U32(num_ctx))
        sym = R.decode_symbols(dec, table, ctx, depth, rate, sac_base,
                               vtable=vtable, rate_lo=rate_lo)
        sym = np.where(active, sym, U32(0))
        if t < S:
            out[t] = sym
        ctxer.advance(sym)
    return out


def build_pos_reset(lane_lengths: np.ndarray, num_steps: int):
    """From per-lane record lengths [Rpl, W] (0-padded), build the per-step
    position and reset matrices [S, W] used by qual/seq context functions.

    Vectorised so the identical construction runs under jit on device
    (see streams_jax.build_pos_reset).
    """
    Rpl, W = lane_lengths.shape
    starts = np.zeros((Rpl, W), dtype=np.int64)
    starts[1:] = np.cumsum(lane_lengths[:-1].astype(np.int64), axis=0)
    reset = np.zeros((num_steps, W), dtype=U32)
    valid = lane_lengths > 0
    r, w = np.nonzero(valid)
    s = starts[r, w]
    keep = s < num_steps
    reset[s[keep], w[keep]] = 1
    # pos[t] = t - last start <= t (int32 accumulate: 2x less bandwidth)
    t_idx = np.arange(num_steps, dtype=np.int32)[:, None]
    start_mark = np.where(reset.astype(bool), t_idx, np.int32(-1))
    last_start = np.maximum.accumulate(start_mark, axis=0)
    pos = (t_idx - np.maximum(last_start, 0)).astype(U32)
    return pos, reset
