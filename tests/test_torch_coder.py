"""The port's lane coder (slimfastq_tpu_torch.ops.coder_torch: Kernels E and
D, here their plain PyTorch versions) and its schedule math
(ops/streams_torch._schedule) against the JAX package's
streams_jax._build_schedule, _build_encode and _build_decode, output for
output, with exact equality: the schedule, eptrs, low, emax and every
ebufs byte on encode, every symbol on decode. The same inputs, made with
numpy from a seed, go to both. Also: the kernels' geometry helpers (the
saturating visit count of their 16-bit entries, the table bytes and
whether a table fits shared memory) by brute force, and a block's streams
coded in the order of the concurrent path against the JAX package's
block."""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu import native as jnative
from slimfastq_tpu import pipeline_native as JPN
from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_jax as SJ
from slimfastq_tpu.pipeline import _seq_symbol_layout
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch import native as tnative
from slimfastq_tpu_torch import pipeline_native as TPN
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import streams_torch as ST

torch.set_num_threads(1)


def _jax_native():
    """The JAX package's native library, loaded again where this process's
    import found none: that package builds it at first import through one
    temporary file shared by every process, so a worker that loses the
    race of concurrent first builds keeps ``lib = None``; by test time the
    racing builds have finished."""
    if jnative.lib is None:
        jnative._load()
    if jnative.lib is None:
        pytest.fail("the JAX package's native library (slimfastq_tpu/native/"
                    "_host.so) did not build or load")
    return jnative


def _geom(level, kind, warm=True):
    cfg = config_for_level(level)
    g = {"qual": cfg.qual, "seq": cfg.seq, "byte": cfg.bytes_,
         "flag": cfg.flags}[kind]
    return g if warm else replace(g, rate_lo=0)


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


def _ragged(rng, S, W, hi):
    counts = rng.integers(0, S + 1, size=W)
    counts[0] = 0
    counts[-1] = S
    return rng.integers(0, hi, size=(S, W)).astype(np.uint32), counts


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def _check(kind, geom, syms, counts, pos=None, reset=None, hard=False,
           mflag=None):
    """mflag: [S, W] u8 match-span flags of a format-v5 SEQ stream (the
    JAX programs' with_mflag variants)."""
    S, W = syms.shape
    Sp = R.pad_steps(S)
    args = [SJ._pad2(x, Sp, W) for x in (syms, pos, reset)]
    mf = [] if mflag is None else [SJ._pad2(mflag, Sp, W)]
    # schedule: the JAX program vs the port's tensor ops
    sched = SJ._build_schedule(kind, geom, Sp, W, with_mflag=bool(mf))
    j_idx, j_bit = (np.asarray(x) for x in sched(
        *(jnp.asarray(a) for a in args),
        jnp.asarray(counts.astype(np.int32)),
        *(jnp.asarray(m) for m in mf)))
    p_idx, p_bit = ST._schedule(kind, geom, *(_t(a) for a in args),
                                _t(counts), *(_t(m) for m in mf))
    assert np.array_equal(p_idx.numpy(), j_idx)
    assert np.array_equal(p_bit.numpy(), j_bit)
    # Kernel E's own rows: the contexts built online from the symbols
    item = CT.EncIn(torch.from_numpy(args[0].astype(np.uint8)),
                    *(_t(a) for a in args[1:]), _t(counts),
                    *(torch.from_numpy(m.astype(np.uint8)) for m in mf))
    o_idx, o_bit = CT.online_schedule(kind, geom, item)
    assert np.array_equal(o_idx.numpy(), j_idx)
    assert np.array_equal(o_bit.numpy(), j_bit)
    # encode: Kernel E's plain version (from the symbols) vs _build_encode
    CB = SJ._chunk_bytes(geom.depth, hard)
    assert CB == ST._chunk_bytes(geom.depth, hard)
    eb, ep, lo, em = SJ._build_encode(kind, geom, Sp, W, hard)(
        jnp.asarray(j_idx), jnp.asarray(j_bit))
    pe = CT.lane_encode(*item[:4], kind, geom, CB, item.mflag)
    NC = Sp // CT.CHUNK_SYMS
    assert np.array_equal(pe[1].numpy(), np.asarray(ep))
    assert np.array_equal(pe[2].numpy().view(np.uint32), np.asarray(lo))
    assert int(pe[3]) == int(em)
    assert np.array_equal(pe[0].numpy(), np.asarray(eb).reshape(NC, W, CB))
    # decode: Kernel D's plain version vs _build_decode on one payload
    payload, lens = SJ._compact_host(np.asarray(eb), np.asarray(ep),
                                     np.asarray(lo), counts, CB)
    Lb = ((max(payload.shape[1], 1) + 2047) // 2048) * 2048
    pay = np.zeros((W, Lb), dtype=np.uint8)
    pay[:, : payload.shape[1]] = payload
    acts = (np.arange(Sp)[:, None] < counts[None, :]).astype(np.int32)
    K = SJ._CHUNK_SYMS
    jd = SJ._build_decode(kind, geom, Sp, W, Lb // 4, with_mflag=bool(mf))(
        jnp.asarray(pay.view("<u4").reshape(-1)),
        jnp.asarray(lens.astype(np.int32)),
        *(jnp.asarray(a.reshape(NC, K, W)) for a in (acts, *args[1:])),
        *(jnp.asarray(m.astype(np.uint32).reshape(NC, K, W)) for m in mf))
    pd = CT.lane_decode(torch.from_numpy(pay), _t(lens), _t(counts),
                        *(_t(a) for a in args[1:]), kind, geom,
                        *(torch.from_numpy(m) for m in mf))
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    mask = acts.astype(bool)
    assert np.array_equal(pd.numpy()[mask], args[0][mask])


@pytest.mark.parametrize("level,warm", [(2, True), (3, True), (3, False),
                                        (4, True)])
def test_qual_coder(level, warm):
    """Level 4 adds the 2-bit q1-q2 delta to the context."""
    rng = np.random.default_rng(10 + level + warm)
    syms, counts, pos, reset = _reads(rng, 40, 16, 40, "qual")
    _check("qual", _geom(level, "qual", warm), syms, counts, pos, reset)


@pytest.mark.parametrize("level,warm", [(2, True), (3, True), (3, False)])
def test_seq_coder(level, warm):
    rng = np.random.default_rng(20 + level + warm)
    syms, counts, pos, reset = _reads(rng, 48, 16, 60, "seq")
    _check("seq", _geom(level, "seq", warm), syms, counts, pos, reset)


def test_byte_coder():
    rng = np.random.default_rng(30)
    syms, counts = _ragged(rng, 200, 8, 256)
    _check("byte", _geom(3, "byte"), syms, counts)


def test_flag_coder():
    rng = np.random.default_rng(32)
    syms, counts = _ragged(rng, 500, 8, 2)
    _check("flag", _geom(3, "flag"), syms, counts)


def test_hard_buffer_variant():
    """The worst-case chunk buffers give the same streams as the
    optimistic ones; both sides take them alike."""
    rng = np.random.default_rng(33)
    syms, counts, pos, reset = _reads(rng, 16, 8, 64, "qual")
    _check("qual", _geom(2, "qual"), syms, counts, pos, reset, hard=True)


def test_seq_collision_w1024():
    """W = 1024 lanes whose reads all start at step 0: at each read start
    every lane marks the same table entry, so the 10-bit count field in
    bits 22-31 wraps (1024 lanes -> count 0). The int32 table of the port
    must wrap exactly as the JAX program's."""
    rng = np.random.default_rng(34)
    syms, counts, pos, reset = _reads(rng, 2048, 1024, 100, "seq",
                                      equal_len=True)
    assert R.pad_steps(syms.shape[0]) == 256
    _check("seq", _geom(3, "seq"), syms, counts, pos, reset)


def _match_spans(rng, syms, pos, counts, lo, hi, flagged):
    """Match-span flags over read positions [lo, hi) of the first
    `flagged` lanes, whose symbols there become e-transform letters
    (mostly 0, an occasional mismatch), as a v5 trial codes them."""
    S, W = syms.shape
    steps = np.arange(S)[:, None]
    mflag = ((pos >= lo) & (pos < hi) & (steps < counts[None, :])
             & (np.arange(W)[None, :] < flagged)).astype(np.uint8)
    e = np.where(rng.random(syms.shape) < 0.9, 0,
                 rng.integers(1, 4, size=syms.shape))
    return np.where(mflag == 1, e, syms).astype(np.uint32), mflag


@pytest.mark.parametrize("order", [11, 10])
def test_seq_coder_match_family(order):
    """Level 4 SEQ with the match-context family (order 11, and order 10,
    the per-block fallback of blocks under 2^20 bases)."""
    rng = np.random.default_rng(40 + order)
    syms, counts, pos, reset = _reads(rng, 48, 16, 60, "seq")
    syms, mflag = _match_spans(rng, syms, pos, counts, 8, 50, 12)
    assert mflag.any()
    _check("seq", replace(_geom(4, "seq"), order=order), syms, counts, pos,
           reset, mflag=mflag)


def test_seq_match_collision_w1024():
    """W = 1024 lanes, every one flagged over the same read positions with
    the same leading e-letters: at the span's first steps all 1,024 lanes
    share one match-family entry, so the 10-bit count field wraps."""
    rng = np.random.default_rng(35)
    syms, counts, pos, reset = _reads(rng, 2048, 1024, 100, "seq",
                                      equal_len=True)
    syms, mflag = _match_spans(rng, syms, pos, counts, 20, 90, 1024)
    syms[(pos >= 18) & (pos < 24)] = 0
    _check("seq", _geom(4, "seq"), syms, counts, pos, reset, mflag=mflag)


def test_wrappers_reject_bad_inputs():
    geom = _geom(3, "qual")
    z = torch.zeros((16, 4), dtype=torch.int32)
    u, c = z.to(torch.uint8), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        CT.lane_encode(z.long(), z, z, c, "qual", geom, 64)
    with pytest.raises(ValueError):
        CT.lane_encode(u[:12], z[:12], z[:12], c, "qual", geom, 64)
    with pytest.raises(ValueError):
        CT.lane_encode(u, None, None, c, "qual", geom, 64)
    c4 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        CT.lane_decode(torch.zeros((4, 8), dtype=torch.uint8),
                       torch.zeros(4, dtype=torch.int64), c4,
                       *(torch.zeros((8, 4), dtype=torch.int32),) * 2,
                       "qual", geom)
    with pytest.raises(ValueError, match="counts"):
        CT.lane_decode(torch.zeros((4, 8), dtype=torch.uint8), c4,
                       torch.zeros((8, 4), dtype=torch.int32),
                       *(torch.zeros((8, 4), dtype=torch.int32),) * 2,
                       "qual", geom)
    with pytest.raises(ValueError, match="mflag"):
        CT.lane_decode(torch.zeros((4, 8), dtype=torch.uint8), c4, c4,
                       *(torch.zeros((8, 4), dtype=torch.int32),) * 2,
                       "seq", _geom(4, "seq"),
                       torch.zeros((8, 4), dtype=torch.int32))


def _oracle_shift(geom, vis):
    """ranger_np.table_update's warm-up shift after `vis` visits."""
    lg = int(R.ceil_log2_counts(np.array([min(vis, 1024) + 1]))[0])
    return min(geom.rate, geom.rate_lo + lg)


@pytest.mark.parametrize("table,level", [(t, lv) for t in ("LEVELS",
                                                           "LEVELS_V1")
                                         for lv in (1, 2, 3, 4)])
def test_visit_cap_is_exact(table, level):
    """The kernels keep min(visits, visit_cap) in 4 bits: for every
    geometry, at qual depths 6, 7 and 8, that count gives the warm-up
    shift of the true count for every count up to 4096."""
    cfg = getattr(tconfig, table)[level]
    geoms = [replace(cfg.qual, depth=d) for d in (6, 7, 8)] + [cfg.seq]
    for g in geoms:
        cap = CT.visit_cap(g)
        if not (0 < g.rate_lo < g.rate):
            assert cap == 0
            continue
        assert 0 < cap < 1 << CT.VIS_BITS
        for v in range(4097):
            assert _oracle_shift(g, min(v, cap)) == _oracle_shift(g, v)
        # and it is the least such count
        assert _oracle_shift(g, cap - 1) != _oracle_shift(g, 1024)
    assert CT.visit_cap(cfg.bytes_) == CT.visit_cap(cfg.flags) == 0


def test_table_bytes_and_shared_memory_fit():
    """16-bit tables: the byte and flag tables fit one CTA's 227 KB (Kernel
    D keeps no other shared memory: the law's counters live in device
    memory); QUAL and SEQ at levels 3 and 4 do not claim to."""
    for level in (1, 2, 3, 4):
        cfg = tconfig.LEVELS[level]
        for g in (cfg.qual, cfg.seq, cfg.bytes_, cfg.flags):
            assert CT.table_bytes(g) == 2 * g.table_size
            fits = (CT.table_bytes(g) + 15) // 16 * 16 <= 232448
            assert CT.table_in_smem(g) == fits
        assert CT.table_in_smem(cfg.bytes_)
        assert CT.table_in_smem(cfg.flags)
        if level >= 3:
            for d in (6, 7, 8):
                assert not CT.table_in_smem(replace(cfg.qual, depth=d))
            assert not CT.table_in_smem(cfg.seq)
    cfg = tconfig.LEVELS[3]
    assert CT.table_bytes(cfg.bytes_) == 131070
    assert CT.table_bytes(cfg.qual) == 1032318
    assert CT.table_bytes(cfg.seq) == 8388612


def test_kernel_geometry_refusals():
    """Every geometry the header names is taken: a visit cap of 16 or 512
    (the most the law allows) with 32-bit entries, FLAG's depth-1 table
    at 17 history bits in device memory; what stays refused is a depth
    past Kernel D's 8 levels (the wrappers raise, never falling back to
    the plain version); any lane count is taken."""
    cpu = torch.device("cpu")
    for rate, rate_lo, cap in ((7, 2, 16), (14, 1, 512)):
        warm = replace(tconfig.LEVELS[3].seq, rate=rate, rate_lo=rate_lo)
        assert CT.visit_cap(warm) == cap
        table, tally, vcap, shape = CT._kernel_geom(warm, 64, cpu)
        # SEQ's padded rows of four 32-bit entries, the visit count 0
        assert (vcap, shape.entry_bytes, shape.padded) == (cap, 4, True)
        assert table.dtype == torch.int32 and table.shape == (shape.entries,)
        assert int(table[0]) == R.PROB_INIT and int(table[-1]) == R.PROB_MAX
        assert tally.dtype == torch.int32 and not tally.any()
        qual = replace(tconfig.LEVELS[3].qual, rate=rate, rate_lo=rate_lo)
        table = CT._kernel_geom(qual, 4097, cpu, 2)[0]
        assert table.dtype == torch.int32 and table.shape[0] == 2
    flag = replace(tconfig.LEVELS[3].flags, hist_bits=17)
    table, tally, vcap, shape = CT._kernel_geom(flag, 64, cpu)
    assert (vcap, shape.table, shape.cluster, shape.entry_bytes) == (
        0, "device", 1, 2)
    assert table.dtype == torch.int16
    assert table.shape == (flag.table_size,) == tally.shape[1:]
    with pytest.raises(ValueError, match="levels"):
        CT._kernel_geom(replace(tconfig.LEVELS[3].bytes_, depth=9), 64, cpu)
    # 4,097 lanes and more are taken: the loop form, its counters 64-bit
    # from 65,536 lanes on
    for W, wide in ((4097, False), (8192, False), (65536, True)):
        table, tally, _, shape = CT._kernel_geom(tconfig.LEVELS[3].qual, W,
                                                 cpu)
        assert shape.cluster * shape.threads * CT.lanes_per_thread(
            shape, W) >= W
        assert tally.dtype == (torch.int64 if wide else torch.int32)
        assert table.shape == (shape.entries,) and not tally.any()
    # 1,025 lanes and more are taken up to 4,096: QUAL over a cluster of
    # CTAs of at most 512 threads
    shape = CT._kernel_geom(tconfig.LEVELS[3].qual, 1025, cpu)[3]
    assert shape.cluster * shape.threads >= 1025 and shape.threads <= 512
    # L3 QUAL's table in device memory, fresh, beside its zeroed counters
    # (a cluster); L3 SEQ's too, in padded rows (a cluster)
    table, tally, cap, shape = CT._kernel_geom(tconfig.LEVELS[3].qual,
                                               1024, cpu)
    assert (cap, shape.table, shape.cluster, shape.padded) == (
        8, "device", 8, False)
    assert table.dtype == torch.int16 and table.shape == (shape.entries,)
    assert int(table[0]) == R.PROB_INIT
    assert int(table[-1]) == R.PROB_MAX
    # the law's counters: one int32 an entry, zero
    assert tally.shape == (1, shape.entries)
    assert tally.dtype == torch.int32 and not tally.any()
    table, tally, cap, shape = CT._kernel_geom(tconfig.LEVELS[3].seq,
                                               1024, cpu)
    assert (shape.table, shape.cluster, shape.padded) == ("device", 8,
                                                           True)
    # SEQ's rows padded to 4 entries: row r's node k at 4 r + k - 1, the
    # sacrificial row at PROB_MAX
    rows = tconfig.LEVELS[3].seq.num_ctx
    assert table.shape == (shape.entries,) == ((rows + 1) * 4,)
    assert int(table[4 * rows - 1]) == R.PROB_INIT
    assert int(table[4 * rows]) == R.PROB_MAX
    # the counters index the unpadded table
    assert tally.shape == (1, tconfig.LEVELS[3].seq.table_size)
    table, tally, cap, shape = CT._kernel_geom(tconfig.LEVELS[3].bytes_,
                                               64, cpu)
    assert (table, cap, shape.table, shape.cluster) == (None, 0, "smem", 1)


@pytest.mark.parametrize("order", ["path", "reversed"])
def test_block_streams_at_once_match_jax(order):
    """A block's streams as the concurrent path codes them (every schedule
    launched before any result is read, QUAL and SEQ first; on decode the
    aux streams first, LEN read back alone, SEQ and QUAL last), also with
    the encode launches reversed, give the JAX package's block: every
    stream's payload and lane lengths, and every decoded stream."""
    jcfg = config_for_level(3, lanes=16, aux_lanes=8)
    cfg = tconfig.from_reference(asdict(jcfg))
    data = synth_fastq(70, read_len=40, seed=8, var_len=True, n_rate=0.02)
    buf = np.frombuffer(data, dtype=np.uint8)
    jidx, n = _jax_native().fastq_index(data)
    jblk = JPN.encode_block_fast(buf, jidx, 0, n, jcfg, SJ)
    tidx, _ = tnative.fastq_index(data)
    pre = TPN.prepare_block_fast(buf, tidx, 0, n, cfg)
    jobs = list(TPN._coder_jobs(pre, cfg, "cpu"))
    assert [j[0] for j in jobs[:2]] == ["QUAL", "SEQ"]
    if order == "reversed":
        jobs = jobs[::-1]
    coded = ST.encode_block(jobs, "cpu")
    tblk = TPN.encode_prepared_block(pre, cfg, "cpu")
    for name, es in jblk.streams.items():
        assert np.array_equal(tblk.streams[name].payload, es.payload), name
        assert np.array_equal(tblk.streams[name].lane_lens, es.lane_lens)
        if name in coded:
            assert np.array_equal(coded[name][0], es.payload), name
            assert np.array_equal(coded[name][1], es.lane_lens), name
        else:
            assert not es.lane_lens.any(), name
    got = TPN.decode_block_device(tblk, cfg, "cpu")
    want = JPN.decode_block_device(jblk, jcfg, SJ)
    for g, w in zip(got, want[:len(got)]):
        if isinstance(g, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert np.array_equal(a, b)
        else:
            assert np.array_equal(g, w)
