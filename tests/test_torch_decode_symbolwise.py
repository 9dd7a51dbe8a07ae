"""Kernel D's order, one synchronisation a symbol-step, against the format's
order, one bit-step at a time, on the CPU.

Kernel D (csrc/coder.cu) decodes every bit of a lane's symbol from the
table as the last symbol-step left it and only then applies the
symbol-step's updates. ``symbolwise_decode`` below is a small torch model
of that order on the plain version's table law (coder_torch._Law): each
bit is marked and decoded in turn, and the depth updates of the
symbol-step follow the last bit. The same payloads, made from seeded numpy
inputs through the JAX package's NumPy oracle (ops/streams_np.py on the
reference's law, ops/ranger_np.py), go to the model, to
``coder_torch.lane_decode_plain`` (the format's bit-step order) and to the
oracle's decode; all three must give the same symbols,
byte for byte, which are the coded ones: QUAL at depth 6 with and without
the warm-up, SEQ with 1,024 lanes on one entry at every read start (the
count field wraps) and with the level-4 match family, the byte kind at
depth 8 and the flag kind (depth 1, where a symbol-step is a bit-step).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_jax as SJ
from slimfastq_tpu.ops import streams_np as SN
from slimfastq_tpu.pipeline import _seq_symbol_layout
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops.ranger import (BOT, CNT_SHIFT, MASK32,
                                            PROB_BITS, RENORM_ITERS)

torch.set_num_threads(1)


def symbolwise_decode(payload, lens, counts, poss, resets, kind, geom,
                      mflag=None):
    """Kernel D's order in plain torch: for each symbol-step, every bit of
    every lane marked and decoded from the table as the last symbol-step
    left it (the tree's levels never share an entry, so a bit's marks and
    reads touch no entry of another bit), then the symbol-step's updates,
    level by level."""
    W, Lb = payload.shape
    Sp = poss.shape[0]
    law = CT._Law(geom, W, "cpu")
    pay = payload.reshape(-1)
    rowoff = torch.arange(W) * Lb
    lens64 = lens.long()
    act_all = torch.arange(Sp)[:, None] < counts.long()[None, :]
    low = torch.zeros(W, dtype=torch.int64)
    rng = torch.full((W,), MASK32, dtype=torch.int64)
    code = torch.zeros(W, dtype=torch.int64)
    ptr = torch.zeros(W, dtype=torch.int64)

    def read(ptr, do):
        b = pay.index_select(0, rowoff + ptr.clamp(max=Lb - 1)).long()
        return b * ((ptr < lens64) & do)

    for _ in range(4):
        code = (code << 8) | read(ptr, torch.ones(W, dtype=torch.bool))
        ptr = ptr + 1
    cst = CT._ctx_init(kind, W, "cpu")
    depth = geom.depth
    syms = torch.zeros((Sp, W), dtype=torch.uint8)
    for t in range(Sp):
        act = act_all[t]
        real = act.int()
        ctx, cst = CT._ctx_step(kind, geom, cst, poss[t].long(),
                                resets[t] != 0,
                                None if mflag is None else mflag[t])
        base = torch.where(act, ctx, geom.num_ctx) * ((1 << depth) - 1) - 1
        node = torch.ones(W, dtype=torch.int64)
        pending = []
        for _ in range(depth):
            idx = base + node
            marked, p = law.mark(idx, real << CNT_SHIFT)
            split = (rng >> PROB_BITS) * p
            one = ((code - low) & MASK32) >= split
            low, rng = CT._coder_step(low, rng, p, one)
            for _ in range(RENORM_ITERS):
                agree, do = CT._renorm(low, rng)
                if not bool(do.any()):
                    break
                rng = torch.where(do & ~agree, (-low) & (BOT - 1), rng)
                code = torch.where(do, ((code << 8) | read(ptr, do))
                                   & MASK32, code)
                ptr = ptr + do
                low = torch.where(do, (low << 8) & MASK32, low)
                rng = torch.where(do, (rng << 8) & MASK32, rng)
            pending.append((idx, marked, p, one))
            node = 2 * node + one
        for idx, marked, p, one in pending:
            law.update(idx, real, marked, p, one)
        sym = (node - (1 << depth)) * act
        cst = CT._ctx_advance(kind, geom, cst, sym)
        syms[t] = sym.to(torch.uint8)
    return syms


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def _decode_three_ways(kind, geom, syms, counts, pos=None, reset=None,
                       mflag=None):
    """Encode with the JAX package's NumPy oracle (streams_np, the
    reference's law in ranger_np), then decode with the symbol-step model,
    lane_decode_plain and the oracle's decode_stream; all equal, and equal
    to the symbols where a step is active."""
    S, W = syms.shape
    Sp = R.pad_steps(S)
    payload, lens = SN.encode_stream(kind, geom, syms, counts, pos, reset,
                                     mflag)
    want = SN.decode_stream(kind, geom, payload, lens, counts, S, pos,
                            reset, mflag)
    pay = np.zeros((W, max(payload.shape[1], 1)), dtype=np.uint8)
    pay[:, : payload.shape[1]] = payload
    pad = [np.zeros((Sp, W), dtype=np.int32) if x is None
           else SJ._pad2(x, Sp, W) for x in (pos, reset)]
    targs = (torch.from_numpy(pay), _t(lens), _t(counts),
             *(_t(a) for a in pad))
    tmf = (None if mflag is None
           else torch.from_numpy(SJ._pad2(mflag, Sp, W).astype(np.uint8)))
    model = symbolwise_decode(*targs, kind, geom, tmf).numpy()
    plain = CT.lane_decode_plain(*targs, kind, geom, tmf).numpy()
    assert np.array_equal(model, plain)
    assert np.array_equal(model[:S], want)
    assert not model[S:].any()
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(model[:S][mask], syms[mask].astype(np.uint8))


def _reads(rng, n, W, maxlen, kind, equal_len=False):
    lengths = (np.full(n, maxlen, dtype=np.int64) if equal_len else
               rng.integers(0, maxlen + 1, size=n).astype(np.int64))
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    if kind == "seq":
        syms = rng.integers(0, 4, size=(S, W))
    else:
        syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, size=(S, W)),
                                      axis=0), 0, 63)
    return syms.astype(np.uint32), counts, pos, reset


@pytest.mark.parametrize("warm", [True, False])
def test_qual_depth6_symbolwise(warm):
    """QUAL at depth 6, with and without the visit-count warm-up, on reads
    that all start at step 0 (every lane on one entry at each read
    start)."""
    geom = config_for_level(3).qual
    if not warm:
        geom = replace(geom, rate_lo=0)
    assert geom.depth == 6
    rng = np.random.default_rng(50 + warm)
    syms, counts, pos, reset = _reads(rng, 48, 24, 20, "qual",
                                      equal_len=True)
    _decode_three_ways("qual", geom, syms, counts, pos, reset)


def test_seq_1024_lanes_on_one_entry_symbolwise():
    """SEQ with 1,024 lanes whose reads all start at step 0: at each read
    start all 1,024 mark one entry and the 10-bit count reads 0."""
    rng = np.random.default_rng(52)
    syms, counts, pos, reset = _reads(rng, 1024, 1024, 16, "seq",
                                      equal_len=True)
    assert R.pad_steps(syms.shape[0]) == 256
    _decode_three_ways("seq", config_for_level(3).seq, syms, counts, pos,
                       reset)


def test_seq_match_family_symbolwise():
    """Level 4's SEQ with the match-context family: flagged steps code in
    the family's rows, 12 of 16 lanes flagged over read positions
    [8, 50)."""
    rng = np.random.default_rng(53)
    syms, counts, pos, reset = _reads(rng, 48, 16, 60, "seq")
    steps = np.arange(syms.shape[0])[:, None]
    mflag = ((pos >= 8) & (pos < 50) & (steps < counts[None, :])
             & (np.arange(16)[None, :] < 12)).astype(np.uint8)
    e = np.where(rng.random(syms.shape) < 0.9, 0,
                 rng.integers(1, 4, size=syms.shape))
    syms = np.where(mflag == 1, e, syms).astype(np.uint32)
    assert mflag.any()
    _decode_three_ways("seq", config_for_level(4).seq, syms, counts, pos,
                       reset, mflag)


@pytest.mark.parametrize("kind,hi,S", [("byte", 256, 120), ("flag", 2, 300)])
def test_byte_and_flag_symbolwise(kind, hi, S):
    """The byte kind at depth 8 (its 256 symbols), and the flag kind at
    depth 1, on ragged lanes."""
    cfg = config_for_level(3)
    geom = cfg.bytes_ if kind == "byte" else cfg.flags
    assert geom.depth == (8 if kind == "byte" else 1)
    rng = np.random.default_rng(54 + hi)
    W = 8
    counts = rng.integers(0, S + 1, size=W)
    counts[-1] = S
    syms = rng.integers(0, hi, size=(S, W)).astype(np.uint32)
    _decode_three_ways(kind, geom, syms, counts)
