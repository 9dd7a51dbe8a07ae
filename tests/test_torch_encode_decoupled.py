"""Kernel E's decoupled encode (slimfastq_tpu_torch.ops.encode_torch), its
six phases composed from their plain PyTorch versions, against the JAX
package's encode (streams_jax._build_schedule + _build_encode, run on
the CPU as tests/test_torch_coder.py runs them) and against the port's
lockstep plain version (coder_torch.lane_encode_blocks_plain), byte for
byte: every ebufs byte, eptrs, low and emax. The cases: QUAL with and
without the visit warm-up; SEQ with every lane on one entry at W = 1024,
700 and 300 (the format's 10-bit count field reads 1,024 as 0 and
512..1023 as negative); SEQ with match flags at level 4; the byte and
flag kinds; a window of blocks of unequal lengths; step slices whose
boundary falls inside a symbol; chunk buffers too small for the stream
(eptr counted past CB, as the caller's hard-chunk rerun sees it). Also
the phases one by one: the rows against the JAX schedule's first bit of
every symbol, and the p the phases give every decision against the
table law stepped in NumPy (ranger_np.table_mark / table_update).
Inputs are made with numpy from a seed; the tolerance is exact
equality."""

from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_jax as SJ
from slimfastq_tpu.pipeline import _seq_symbol_layout
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import encode_torch as E

torch.set_num_threads(1)


def _geom(level, kind, warm=True):
    cfg = config_for_level(level)
    g = {"qual": cfg.qual, "seq": cfg.seq, "byte": cfg.bytes_,
         "flag": cfg.flags}[kind]
    return g if warm else replace(g, rate_lo=0)


def _stream(rng, kind, W, n_reads=None, maxlen=40, equal_len=False,
            S=None):
    """(syms [S, W] u32, counts, pos, reset) of one stream: reads laid
    out as the pipeline lays them for seq and qual (equal_len: every lane
    at one context at each read start), ragged lanes for byte and flag."""
    if kind in ("seq", "qual"):
        n = n_reads or 2 * W
        lengths = (np.full(n, maxlen, dtype=np.int64) if equal_len else
                   rng.integers(0, maxlen + 1, size=n).astype(np.int64))
        _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
        if kind == "seq":
            syms = rng.integers(0, 4, size=(S, W))
        else:
            syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, size=(S, W)),
                                          axis=0), 0, 63)
        return syms.astype(np.uint32), counts, pos, reset
    counts = rng.integers(0, S + 1, size=W)
    counts[-1] = S
    syms = rng.integers(0, 256 if kind == "byte" else 2, size=(S, W))
    return syms.astype(np.uint32), counts, None, None


def _jax_encode(kind, geom, syms, counts, pos, reset, mflag=None,
                hard=False):
    """The JAX package's encode of one stream: (schedule idx, bit [NC,
    8*depth, W], ebufs [NC, W, CB], eptrs, low, emax), and the port's
    EncIn of the same padded inputs."""
    S, W = syms.shape
    Sp = R.pad_steps(S)
    args = [SJ._pad2(x, Sp, W) for x in (syms, pos, reset)]
    mf = [] if mflag is None else [SJ._pad2(mflag, Sp, W)]
    j_idx, j_bit = (np.asarray(x) for x in SJ._build_schedule(
        kind, geom, Sp, W, with_mflag=bool(mf))(
        *(jnp.asarray(a) for a in args), jnp.asarray(counts.astype(np.int32)),
        *(jnp.asarray(m) for m in mf)))
    eb, ep, lo, em = SJ._build_encode(kind, geom, Sp, W, hard)(
        jnp.asarray(j_idx), jnp.asarray(j_bit))
    NC = Sp // CT.CHUNK_SYMS
    CB = SJ._chunk_bytes(geom.depth, hard)
    per_read = kind in ("seq", "qual")

    def t32(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))
    item = CT.EncIn(torch.from_numpy(args[0].astype(np.uint8)),
                    t32(args[1]) if per_read else None,
                    t32(args[2]) if per_read else None, t32(counts),
                    torch.from_numpy(mf[0].astype(np.uint8)) if mf else None)
    want = (np.asarray(eb).reshape(NC, W, CB), np.asarray(ep),
            np.asarray(lo), int(em))
    return j_idx, j_bit, want, item, CB


@contextmanager
def _slices(L, B, W):
    """Kernel E in slices of L bit-steps of B blocks of W lanes (None: its
    default slices)."""
    saved = E.SLICE_DECISIONS
    if L is not None:
        E.SLICE_DECISIONS = L * B * W
    try:
        yield
    finally:
        E.SLICE_DECISIONS = saved


def _same(got, want):
    eb, ep, lo, em = got
    assert np.array_equal(eb.numpy(), want[0])
    assert np.array_equal(ep.numpy(), want[1])
    assert np.array_equal(lo.numpy().view(np.uint32), want[2])
    assert int(em) == want[3]


def _both(kind, geom, syms, counts, pos, reset, mflag=None, L=None,
          hard=False):
    """The decoupled encode's plain phases (through lane_encode_blocks, in
    slices of L bit-steps) against the JAX package's encode and the
    lockstep plain version."""
    _, _, want, item, CB = _jax_encode(kind, geom, syms, counts, pos, reset,
                                       mflag, hard)
    with _slices(L, 1, syms.shape[1]):
        _same(CT.lane_encode_blocks([item], kind, geom, CB)[0], want)
    _, checked = CT._check_items([item], kind, geom)
    _same(CT.lane_encode_blocks_plain(checked, kind, geom, CB)[0], want)
    return checked[0], CB


@pytest.mark.parametrize("warm", [True, False])
def test_qual_warm_and_cold(warm):
    rng = np.random.default_rng(50 + warm)
    syms, counts, pos, reset = _stream(rng, "qual", 16, n_reads=40)
    _both("qual", _geom(3, "qual", warm), syms, counts, pos, reset)


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("W", [1024, 700, 300])
def test_seq_every_lane_on_one_entry(level, W):
    """Every lane's reads start at step 0: each read start puts all W
    lanes on one entry (1,024 reads as a count of 0, 700 as negative,
    300 scales the delta down)."""
    rng = np.random.default_rng(60 + W + level)
    syms, counts, pos, reset = _stream(rng, "seq", W, n_reads=2 * W,
                                       maxlen=12, equal_len=True)
    _both("seq", _geom(level, "seq"), syms, counts, pos, reset)


def test_seq_match_flags_level4():
    """Level 4's SEQ coded with the match-context family: flagged spans
    of mostly-0 e-letters, every lane flagged at the same positions."""
    rng = np.random.default_rng(70)
    syms, counts, pos, reset = _stream(rng, "seq", 64, n_reads=128,
                                       maxlen=30, equal_len=True)
    steps = np.arange(syms.shape[0])[:, None]
    mflag = ((pos >= 6) & (pos < 24) & (steps < counts[None, :])).astype(
        np.uint8)
    e = np.where(rng.random(syms.shape) < 0.9, 0,
                 rng.integers(1, 4, size=syms.shape))
    syms = np.where(mflag == 1, e, syms).astype(np.uint32)
    syms[(pos >= 5) & (pos < 8)] = 0
    _both("seq", _geom(4, "seq"), syms, counts, pos, reset, mflag=mflag)


@pytest.mark.parametrize("kind,S", [("byte", 40), ("flag", 120)])
def test_aux_kinds(kind, S):
    rng = np.random.default_rng(80 + S)
    syms, counts, _, _ = _stream(rng, kind, 8, S=S)
    _both(kind, _geom(3, kind), syms, counts, None, None)


@pytest.mark.parametrize("kind,L", [("qual", 7), ("qual", 250),
                                    ("seq", 3), ("byte", 13)])
def test_slice_boundary_inside_a_symbol(kind, L):
    """Slices of L bit-steps, L not a multiple of the tree depth: a slice
    ends inside a symbol, whose row is built again from the carried
    context state; the table, low, range and chunk position carry."""
    rng = np.random.default_rng(90 + L)
    if kind == "byte":
        syms, counts, pos, reset = _stream(rng, kind, 8, S=30)
    else:
        syms, counts, pos, reset = _stream(rng, kind, 16, n_reads=40)
    assert L % _geom(3, kind).depth
    _both(kind, _geom(3, kind), syms, counts, pos, reset, L=L)


def test_window_of_unequal_blocks():
    """One launch set over three blocks of different step counts (one
    with three active lanes), in slices that end inside a symbol: each
    block's outputs are its own JAX encode's."""
    rng = np.random.default_rng(95)
    geom = _geom(3, "qual")
    wants, items = [], []
    for n_reads, maxlen, equal in ((40, 60, False), (16, 20, False),
                                   (3, 300, True)):
        syms, counts, pos, reset = _stream(rng, "qual", 16, n_reads, maxlen,
                                           equal)
        _, _, want, item, CB = _jax_encode("qual", geom, syms, counts, pos,
                                           reset)
        wants.append(want)
        items.append(item)
    assert len({it.syms.shape[0] for it in items}) == 2
    for L in (None, 100):
        with _slices(L, len(items), 16):
            for got, want in zip(E.encode_blocks(items, "qual", geom, CB),
                                 wants):
                _same(got, want)


def test_hard_chunk_rerun():
    """Chunk windows too small for the stream: eptr counts past CB (the
    caller's overflow check) exactly as the hard-size run counts, whose
    bytes equal the JAX package's hard-size encode and begin with the
    small run's."""
    rng = np.random.default_rng(97)
    geom = _geom(3, "byte")
    syms, counts, _, _ = _stream(rng, "byte", 8, S=40)
    item, CB = _both("byte", geom, syms, counts, None, None, L=11,
                     hard=True)
    with _slices(11, 1, 8):
        small = E.encode_blocks([item], "byte", geom, 4)[0]
        hard = E.encode_blocks([item], "byte", geom, CB)[0]
    assert int(small[3]) > 4
    assert torch.equal(small[1], hard[1]) and torch.equal(small[2], hard[2])
    assert torch.equal(small[0], hard[0][:, :, :4])


@pytest.mark.parametrize("L,blocks", [(None, (16,)), (7, (16,)),
                                      (100, (24, 16, 8)), (64, (24, 8))])
def test_set_slices_counts_the_slices(monkeypatch, L, blocks):
    """set_slices (a coder span's ``slices``; the count enc_run's call
    takes) equals the slices encode_blocks walks: the rows phase runs
    once a slice."""
    rng = np.random.default_rng(len(blocks))
    geom, W = _geom(3, "byte"), 8
    items = [CT.EncIn(torch.from_numpy(rng.integers(0, 256, (Sp, W),
                                                    dtype=np.uint8)),
                      None, None, torch.full((W,), Sp, dtype=torch.int32))
             for Sp in blocks]
    runs = []
    rows_plain = E.rows_plain
    monkeypatch.setattr(E, "rows_plain",
                        lambda es, s0: runs.append(s0) or rows_plain(es, s0))
    with _slices(L, len(items), W):
        n = E.set_slices(items, geom.depth)
        CT.lane_encode_blocks(items, "byte", geom, 4)
    S = max(blocks) * geom.depth
    assert n == len(runs) == (1 if L is None else -(-S // L))
    assert runs == list(range(0, S, S if L is None else L))


def _law_p(j_idx, j_bit, geom):
    """p of every decision [bit-steps, W] by the table law stepped in
    NumPy (ranger_np.table_mark / table_update), from the JAX schedule."""
    idx = j_idx.reshape(-1, j_idx.shape[-1])
    bit = j_bit.reshape(-1, j_bit.shape[-1])
    table = R.table_init(geom.table_size, geom.sac_base)
    warm = 0 < getattr(geom, "rate_lo", 0) < geom.rate
    vt = np.zeros(geom.table_size, dtype=np.int32) if warm else None
    out = np.zeros(idx.shape, dtype=np.int64)
    for s in range(idx.shape[0]):
        i = idx[s].astype(np.int64)
        R.table_mark(table, i, geom.sac_base)
        marked = table[i]
        out[s] = np.clip(marked & ((1 << R.CNT_SHIFT) - 1), R.PROB_MIN,
                         R.PROB_MAX)
        R.table_update(table, i, marked, bit[s], geom.rate, geom.sac_base,
                       vtable=vt, rate_lo=getattr(geom, "rate_lo", 0))
    return out


@pytest.mark.parametrize("kind,W,L", [("qual", 16, 40), ("seq", 300, 5)])
def test_phases_against_the_law(kind, W, L):
    """The phases one slice at a time: the rows equal the JAX schedule's
    entry of every symbol's first bit; the p that touches, sort and the
    entry scan give every decision (through its record) equal the table
    law stepped lane by lane in NumPy, and so do the gather's, beside
    each decision's bit; the records of a step are its distinct real
    entries in the order of their first lanes."""
    rng = np.random.default_rng(99 + W)
    geom = _geom(3, kind)
    syms, counts, pos, reset = _stream(
        rng, kind, W, n_reads=2 * W if kind == "seq" else 40,
        maxlen=12 if kind == "seq" else 40, equal_len=kind == "seq")
    j_idx, j_bit, _, item, CB = _jax_encode(kind, geom, syms, counts, pos,
                                            reset)
    p_law = _law_p(j_idx, j_bit, geom)
    idx, bits = j_idx.reshape(-1, W), j_bit.reshape(-1, W)
    depth = geom.depth
    with _slices(L, 1, W):
        es = E.EncodeSet([item], kind, geom, CB)
    for s0 in range(0, es.S, es.L):
        s1 = min(s0 + es.L, es.S)
        E.rows(es, s0)
        t0 = s0 // depth
        for t in range(t0, -(-s1 // depth)):
            assert np.array_equal(es.rows[0, t - t0].numpy(),
                                  idx[t * depth])
        E.touches(es, s0)
        for s in range(s0, s1):
            row = idx[s]
            real = row < geom.sac_base
            firsts = []
            for w in np.flatnonzero(real):
                if row[w] not in firsts:
                    firsts.append(row[w])
            at, n_s = int(es.cnt[s - s0]), int(es.cnt[s - s0 + 1]) - int(
                es.cnt[s - s0])
            assert es.key[at: at + n_s].tolist() == firsts
        E.sort(es)
        E.entry_scan(es)
        off = es.cnt[:s1 - s0].long()
        rid = es.rid[0, :s1 - s0].long()
        p = torch.where(rid < 0, R.PROB_MAX,
                        es.nk[off[:, None] + rid.clamp(min=0)].long())
        assert np.array_equal(p.numpy(), p_law[s0:s1])
        E.gather(es, s0)
        q = es.rid[0, :s1 - s0].long() & 0xFFFF
        assert np.array_equal((q & 0xFFF).numpy(), p_law[s0:s1])
        assert np.array_equal((q >> E.BIT_SHIFT).numpy(), bits[s0:s1])
        E.code(es, s0)
