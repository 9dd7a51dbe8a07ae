"""Kernels E, D, C, L and U against their plain PyTorch versions on a
CUDA card,
byte for byte, on each table placement (shared memory, device memory),
with and without the visit warm-up, at the collision counts where the
format's count field wraps, and with the level-4 match-context family and
q1-q2 delta; a block (also a level-4 block with match trials) coded
with its streams at once against the same block coded one stream at a
time; Kernels E and D over a ragged window of blocks against their plain
versions and against one launch per block; Kernel C's one launch over
many streams (also a window's 88) against its plain version and against
each stream compacted alone; the small-block window path end to end;
the host-pack path (forced on small blocks) against the main path's
containers; and the sharded path on a mesh of
one card, of the card named twice, and (with two cards or more) of two
cards, against the sequential containers; the pure-Python pipeline
(``use_native=False``) stream by stream on the card; the entry points
(``entry()`` against its CPU run, ``dryrun_multichip`` over every card);
Kernel E's six phases each against its plain version, slice by slice,
also over a stream of several slices; a launch set of E issued by one
host call (enc_run) against the plain phases and the lockstep form, with
its launch counts, also on the main path; Kernel D's cluster form (a SEQ
stream's 1,024 lanes of 100-base reads over 8 CTAs; QUAL's in every
1,024-lane case) against its plain version where the colliding lanes lie
in every CTA, with level 4's match family, and over a ragged window; and
SEQ's other shape, one CTA for 1,500-base reads, chosen by its inputs;
past 4,096 lanes (up to 65,536, every lane on one entry) D's loop form
and E's touches over chunks, any lane count taken; geometries past the
built-in levels' (visit caps of 16 and 512 in 32-bit entries, in every
table placement and shape, with 512 lanes and more on one entry, also
over several of E's slices; FLAG's depth-1 table at 17 history bits in
device memory, in one CTA and over a cluster). Each test runs under
an alarm of CARD_TEST_LIMIT_S. Marked `cuda`: they
skip without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch and a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import signal
from dataclasses import replace

import numpy as np
import pytest
import torch

from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import compact_torch as CC
from slimfastq_tpu_torch.ops import streams_torch as ST

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# seconds a card test may take: SIGALRM's default action then ends the run,
# so a kernel that never returns cannot hold the card
CARD_TEST_LIMIT_S = 600


@pytest.fixture(autouse=True)
def _time_limit():
    signal.alarm(CARD_TEST_LIMIT_S)
    yield
    signal.alarm(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stream(kind, rng, dev, W, active=None, hi=64, match=False, Sp=256):
    """(syms, counts, pos, reset, mflag) on the card: reads of 100 symbols
    that all start at step 0 for seq/qual in the first `active` lanes
    (every active lane at one context at each read start; the others
    empty), ragged lanes for byte/flag. With `match` (seq), every active
    lane is flagged over read positions [20, 90), whose symbols are
    e-transform letters (mostly 0) and all 0 at positions 18-23: at the
    span's first steps the active lanes share one match-family entry."""
    if kind in ("seq", "qual"):
        ll = np.full((Sp // 100, W), 100, dtype=np.int64)
        ll[:, W if active is None else active:] = 0
        counts = ll.sum(axis=0)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        if kind == "seq":
            syms = rng.integers(0, 4, size=(Sp, W))
        else:
            syms = np.clip(hi // 2 + np.cumsum(rng.integers(-2, 3, (Sp, W)),
                                               axis=0), 0, hi - 1)
    else:
        counts = rng.integers(Sp // 2, Sp + 1, size=W)
        syms = rng.integers(0, 256 if kind == "byte" else 2, size=(Sp, W))
        pos = reset = torch.zeros((Sp, W), dtype=torch.int32, device=dev)
    mflag = None
    if match:
        p = pos.cpu().numpy()
        span = (p >= 20) & (p < 90) & (np.arange(Sp)[:, None]
                                       < counts[None, :])
        e = np.where(rng.random((Sp, W)) < 0.9, 0, syms)
        syms = np.where(span, e, syms)
        syms[(p >= 18) & (p < 24)] = 0
        mflag = torch.from_numpy(span.astype(np.uint8)).to(dev)
    return (torch.from_numpy(syms.astype(np.uint8)).to(dev), counts, pos,
            reset, mflag)


def _geom(level, kind, depth=None):
    cfg = config_for_level(level)
    g = {"seq": cfg.seq, "qual": cfg.qual, "byte": cfg.bytes_,
         "flag": cfg.flags}[kind]
    return g if depth is None else replace(g, depth=depth)


# (level, kind, W, hard, active lanes, qual depth, table in shared memory,
# match-span flags)
CASES = {
    "seq-collide-1024": (3, "seq", 1024, False, None, None, False, False),
    "seq-collide-700": (3, "seq", 1024, False, 700, None, False, False),
    "seq-collide-300": (3, "seq", 1024, False, 300, None, False, False),
    "qual-d6": (3, "qual", 1024, False, None, None, False, False),
    "qual-d8": (3, "qual", 1024, False, None, 8, False, False),
    "qual-hard": (3, "qual", 256, True, None, None, False, False),
    "qual-w128": (3, "qual", 128, False, None, None, False, False),
    "seq-l1": (1, "seq", 1024, False, None, None, True, False),
    "qual-l1": (1, "qual", 1024, False, None, None, True, False),
    "byte": (3, "byte", 64, False, None, None, True, False),
    "flag": (3, "flag", 64, False, None, None, True, False),
    "seq-l4-match-1024": (4, "seq", 1024, False, None, None, False, True),
    "seq-l4-match-700": (4, "seq", 1024, False, 700, None, False, True),
    "qual-l4": (4, "qual", 1024, False, None, None, False, False),
    # past 1,024 lanes: more than 1,024 lanes on one entry (the count
    # field wraps), ragged last CTAs and warps, two and four lanes a thread
    # where the table lives in shared memory
    "seq-w1500-collide-1100": (3, "seq", 1500, False, 1100, None, False,
                               False),
    "qual-w2048": (3, "qual", 2048, False, None, None, False, False),
    "seq-w4096-collide": (3, "seq", 4096, False, None, None, False, False),
    "seq-l4-match-w2048-1100": (4, "seq", 2048, False, 1100, None, False,
                                True),
    "qual-l1-w4096": (1, "qual", 4096, False, None, None, True, False),
    "byte-w2048": (3, "byte", 2048, False, None, None, True, False),
    "flag-w1500": (3, "flag", 1500, False, None, None, True, False),
    "byte-w4096": (3, "byte", 4096, False, None, None, True, False),
    # past 4,096 lanes: D's loop form (every kind's table in device
    # memory, the flag kind's depth 1 too), E's touches over chunks with
    # the step's hash in device memory; at 65,536 lanes on one entry D's
    # 64-bit counters and E's 32-bit record fields
    "seq-w8192-collide": (3, "seq", 8192, False, None, None, False, False),
    "qual-w5000-collide-4500": (3, "qual", 5000, False, 4500, None, False,
                                False),
    "seq-l4-match-w8192-5000": (4, "seq", 8192, False, 5000, None, False,
                                True),
    "qual-l1-w8192": (1, "qual", 8192, False, None, None, True, False),
    "byte-w8192": (3, "byte", 8192, False, None, None, True, False),
    "flag-w5000": (3, "flag", 5000, False, None, None, True, False),
    "seq-w65536-collide": (3, "seq", 65536, False, None, None, False, False),
    "qual-w65536-collide": (3, "qual", 65536, False, None, None, False,
                            False),
    # geometries the header names past the built-in levels': visit caps of
    # 16 (rate 7, rate_lo 2) and 512 (14 / 1) in 32-bit entries, 512 lanes
    # and more on one entry (QUAL's 1,024 at each read start, SEQ's 700 or
    # 1,024): a device table over a cluster, in one CTA (padded and not),
    # in shared memory (level 1's QUAL, one, two and four lanes a thread)
    # and in the loop form (padded and not, its counters 32- and 64-bit);
    # FLAG at 17 history bits, its depth-1 table in device memory in one
    # CTA and over a cluster
    "qual-cap16": (3, "qual", 1024, False, None, None, False, False),
    "qual-cap512": (3, "qual", 1024, False, None, None, False, False),
    "seq-cap16-collide-1024": (3, "seq", 1024, False, None, None, False,
                               False),
    "seq-cap512-collide-700": (3, "seq", 1024, False, 700, None, False,
                               False),
    "seq-cap512-w64": (3, "seq", 64, False, None, None, False, False),
    "qual-cap16-w128": (3, "qual", 128, False, None, None, False, False),
    "qual-l1-cap16": (1, "qual", 1024, False, None, None, True, False),
    "qual-l1-cap512-w2048": (1, "qual", 2048, False, None, None, True,
                             False),
    "qual-l1-cap16-w4096": (1, "qual", 4096, False, None, None, True,
                            False),
    "qual-cap512-w8192": (3, "qual", 8192, False, None, None, False, False),
    "seq-cap16-w8192": (3, "seq", 8192, False, None, None, False, False),
    "qual-cap16-w65536": (3, "qual", 65536, False, None, None, False,
                          False),
    "seq-cap512-w65536": (3, "seq", 65536, False, None, None, False,
                          False),
    "flag-hist17": (3, "flag", 64, False, None, None, False, False),
    "flag-hist17-w1024": (3, "flag", 1024, False, None, None, False, False),
}
# each geometry case's change from its level's geometry
CASE_GEOMS = {c: (dict(rate=7, rate_lo=2) if "cap16" in c
                  else dict(rate=14, rate_lo=1) if "cap512" in c
                  else dict(hist_bits=17))
              for c in CASES if "cap" in c or "hist17" in c}


def _case_geom(case):
    """A CASES entry's geometry: its level's, with CASE_GEOMS' change."""
    level, kind, _, _, _, depth, _, _ = CASES[case]
    return replace(_geom(level, kind, depth), **CASE_GEOMS.get(case, {}))


@pytest.mark.parametrize("case", list(CASES))
def test_coder_and_compact_kernels_match_plain(dev, case):
    level, kind, W, hard, active, depth, smem, match = CASES[case]
    geom = _case_geom(case)
    assert CT.table_in_smem(geom) == smem
    rng = np.random.default_rng(1)
    syms, counts, pos, reset, mflag = _stream(kind, rng, dev, W, active,
                                              hi=1 << (depth or 6),
                                              match=match)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    CB = ST._chunk_bytes(geom.depth, hard)
    ke = CT.lane_encode(syms, pos, reset, c, kind, geom, CB, mflag)
    pe = CT.lane_encode_blocks_plain([CT.EncIn(syms, pos, reset, c, mflag)],
                                     kind, geom, CB)[0]
    for a, b in zip(ke, pe):
        assert torch.equal(a.cpu(), b.cpu())
    ebufs, eptrs, low, emax = ke
    assert int(emax) <= CB
    Bmax = int(eptrs.sum(dim=0).max()) + 5
    kc = CC.compact_lanes_dev(ebufs, eptrs, Bmax)
    pc = CC.compact_lanes_plain(ebufs, eptrs, Bmax)
    for a, b in zip(kc, pc):
        assert torch.equal(a.cpu(), b.cpu())
    pay, lens = ST._flush_append(kc[0].cpu().numpy(),
                                 kc[1].cpu().numpy().astype(np.int64),
                                 low.cpu().numpy().view(np.uint32), counts)
    Sp = syms.shape[0]
    args = (torch.from_numpy(pay).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev),
            c, pos, reset)
    kd = CT.lane_decode(*args, kind, geom, mflag)
    pd = CT.lane_decode_plain(*args, kind, geom, mflag)
    assert torch.equal(kd.cpu(), pd.cpu())
    mask = torch.arange(Sp, device=dev)[:, None] < c[None, :]
    assert torch.equal(kd[mask], syms[mask])


@pytest.mark.parametrize("case", list(CASES))
def test_encode_phases_match_plain(dev, case, monkeypatch):
    """Each of Kernel E's phases (rows, touches, sort, entry scan, gather,
    lane coder) against its plain version on whole outputs, slice by
    slice (encode_torch.compare_phases), at the shapes above; QUAL in
    slices of 1,000 bit-steps, which end inside a symbol and a chunk."""
    from slimfastq_tpu_torch.ops import encode_torch as E
    level, kind, W, hard, active, depth, smem, match = CASES[case]
    geom = _case_geom(case)
    rng = np.random.default_rng(1)
    syms, counts, pos, reset, mflag = _stream(kind, rng, dev, W, active,
                                              hi=1 << (depth or 6),
                                              match=match)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    _, items = CT._check_items([CT.EncIn(syms, pos, reset, c, mflag)],
                               kind, geom)
    if kind == "qual":
        monkeypatch.setattr(E, "SLICE_DECISIONS", 1000 * W)
    E.compare_phases(items, kind, geom, ST._chunk_bytes(geom.depth, hard))


def test_encode_long_stream_crosses_slices(dev, monkeypatch):
    """A QUAL stream of 4,096 steps (24,576 bit-steps, 6 slices of the
    default size) through the kernels equals its phases' plain versions
    at the default slices and the kernels at slices of 4,999 bit-steps:
    the table and each lane's coder state carry from slice to slice."""
    from slimfastq_tpu_torch.ops import encode_torch as E
    geom = _geom(3, "qual")
    rng = np.random.default_rng(6)
    syms, counts, pos, reset, _ = _stream("qual", rng, dev, 1024, Sp=4096)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    item = CT.EncIn(syms, pos, reset, c)
    CB = ST._chunk_bytes(geom.depth, False)
    assert E.slice_steps(1, 1024, 4096 * 6) * 5 < 4096 * 6
    E.compare_phases([item], "qual", geom, CB)
    whole = CT.lane_encode(syms, pos, reset, c, "qual", geom, CB)
    monkeypatch.setattr(E, "SLICE_DECISIONS", 4999 * 1024)
    for a, b in zip(whole, CT.lane_encode(syms, pos, reset, c, "qual",
                                          geom, CB)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate,rate_lo", [(7, 2), (14, 1)])
def test_encode_warm_stream_crosses_slices(dev, monkeypatch, rate,
                                           rate_lo):
    """A QUAL stream at visit caps 16 and 512 (32-bit entries) of 1,024
    steps over 1,024 lanes (every lane on one entry at each read start), in
    slices of 999 bit-steps (7): each of E's phases against its plain
    version slice by slice, and E whole against the lockstep plain form,
    so the tables carried between slices keep the whole visit count."""
    from slimfastq_tpu_torch.ops import encode_torch as E
    geom = replace(_geom(3, "qual"), rate=rate, rate_lo=rate_lo)
    assert CT.entry_bytes(geom) == 4
    rng = np.random.default_rng(rate)
    syms, counts, pos, reset, _ = _stream("qual", rng, dev, 1024, Sp=1024)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    item = CT.EncIn(syms, pos, reset, c)
    CB = ST._chunk_bytes(geom.depth, False)
    monkeypatch.setattr(E, "SLICE_DECISIONS", 999 * 1024)
    assert E.slice_steps(1, 1024, 1024 * 6) * 6 < 1024 * 6
    E.compare_phases([item], "qual", geom, CB)
    got = CT.lane_encode(syms, pos, reset, c, "qual", geom, CB)
    for a, b in zip(got, CT.lane_encode_blocks_plain([item], "qual", geom,
                                                     CB)[0]):
        assert torch.equal(a, b)


# Kernel E's one-call driver (enc_run): (level, kind, W, [(Sp, active
# lanes)] a block, match-span flags, geometry change, bit-steps a slice).
# QUAL in 4 blocks of unequal lengths in slices of 1,000 bit-steps (they
# end inside a symbol and a chunk, and past some blocks' ends); SEQ with
# level 4's match flags; 4,097 lanes, whose touches run over chunks with
# the hash in device memory; QUAL at a visit cap of 16 (32-bit entries)
RUN_CASES = {
    "qual-b4": (3, "qual", 1024, [(256, None), (512, 900), (104, 1),
                                  (384, None)], False, {}, 1000),
    "seq-l4-match": (4, "seq", 1024, [(256, 700), (200, None)], True, {},
                     150),
    "seq-w4097": (3, "seq", 4097, [(256, None)], False, {}, 200),
    "qual-cap16": (3, "qual", 1024, [(512, None)], False,
                   dict(rate=7, rate_lo=2), 999),
}


def _plain_phases(items, kind, geom, CB):
    """The six phases' plain versions composed over the launch set's
    slices (what encode_blocks runs on CPU tensors), on the card."""
    from slimfastq_tpu_torch.ops import encode_torch as E
    es = E.EncodeSet(items, kind, geom, CB)
    for s0 in range(0, es.S, es.L):
        for name, _, sliced in E.STEPS:
            E.PLAIN[name](es, *((s0,) if sliced else ()))
    return es.results()


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_encode_run_matches_plain(dev, case, monkeypatch):
    """A launch set issued by one enc_run call gives the bytes of the
    plain phases composed slice by slice and of the lockstep plain form
    (lane_encode_blocks_plain): every chunk byte, eptrs, low and emax;
    it counts one encode_run over its slices and each phase once a
    slice."""
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import encode_torch as E
    level, kind, W, blocks, match, change, L = RUN_CASES[case]
    geom = replace(_geom(level, kind), **change)
    rng = np.random.default_rng(9)
    items = []
    for Sp, active in blocks:
        syms, cnt, pos, reset, mflag = _stream(kind, rng, dev, W, active,
                                               match=match, Sp=Sp)
        c = torch.from_numpy(cnt.astype(np.int32)).to(dev)
        items.append(CT.EncIn(syms, pos, reset, c, mflag))
    _, items = CT._check_items(items, kind, geom)
    monkeypatch.setattr(E, "SLICE_DECISIONS", L * len(items) * W)
    n = E.set_slices(items, geom.depth)
    assert n > 2 and E.slice_steps(len(items), W, 1 << 30) == L
    CB = ST._chunk_bytes(geom.depth, False)
    _cuda.reset_launches()
    got = CT.lane_encode_blocks(items, kind, geom, CB)
    assert (_cuda.launches["encode_run"], _cuda.descs["encode_run"]) == (
        1, n)
    for k in E.STEPS:
        name = f"encode_{k[0]}"
        assert (_cuda.launches[name], _cuda.descs[name]) == (
            n, n * len(items))
    for a, b, c in zip(got, _plain_phases(items, kind, geom, CB),
                       CT.lane_encode_blocks_plain(items, kind, geom, CB)):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)
            assert torch.equal(x, z)


def test_block_streams_at_once_equal_one_at_a_time(dev):
    """A block's seven streams coded concurrently (encode_prepared_block,
    decode_block_device) against each stream coded alone on the default
    stream with a synchronisation between."""
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.pipeline_native import (
        decode_block_device, encode_prepared_block, prepare_block_fast,
        seq_qual_args)
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    cfg = config_for_level(3, block_records=4096)
    data = synth_fastq(4096, read_len=100, seed=5, var_len=True,
                       n_rate=0.01)
    idx, n = native.fastq_index(data)
    pre = prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0, n,
                             cfg)
    blk = encode_prepared_block(pre, cfg, dev)
    alone = ST.encode_seq_qual_raw(*seq_qual_args(pre, cfg), dev)
    for name, es in blk.streams.items():
        if name in alone:
            payload, lens = alone[name]
        else:
            kind, geom, syms, counts = pre[0][name][:4]
            payload, lens = ST.encode_stream(kind, geom, syms, counts, dev)
        torch.cuda.synchronize()
        assert np.array_equal(es.lane_lens, lens), name
        assert np.array_equal(es.payload, payload), name
    inter = decode_block_device(blk, cfg, dev)
    lanes = dict(zip(("IDD", "IDX", "SEQX"), inter[4:7]))
    for name, got in lanes.items():
        es = blk.streams[name]
        want = ST.decode_stream("byte", cfg.bytes_, es.payload, es.lane_lens,
                                es.sym_counts, int(es.sym_counts.max()), dev)
        for w, row in enumerate(got):
            assert np.array_equal(row, want[: len(row), w]), name


def test_match_trial_block_at_once_equal_one_at_a_time(dev):
    """A level-4 block with match trials: its plain SEQ, trial SEQs and
    MATCH streams coded at once beside QUAL (encode_prepared_block)
    against each coded alone with a synchronisation between, the trial
    choice made again from those; then its decode on the card."""
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    from slimfastq_tpu_torch.pipeline_native import (
        decode_block_device, decode_block_finish, encode_prepared_block,
        prepare_block_fast, seq_qual_args)
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    cfg = config_for_level(4, block_records=4096)
    data = synth_fastq(4096, read_len=100, seed=5, n_rate=0.001)
    idx, n = native.fastq_index(data)
    pre = prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0, n,
                             cfg)
    trials = pre[6]["trials"]
    assert trials
    blk = encode_prepared_block(pre, cfg, dev)
    alone = ST.encode_seq_qual_raw(*seq_qual_args(pre, cfg), dev)
    torch.cuda.synchronize()
    best, flags = int(alone["SEQ"][1].sum()), 0
    for t, alt, msyms, mcounts, mflag in trials:
        seq = ST.encode_seq_qual_raw(*seq_qual_args(pre, cfg, alt), dev,
                                     seq_mflag=mflag, only=("SEQ",))["SEQ"]
        torch.cuda.synchronize()
        match = ST.encode_stream("byte", cfg.bytes_, msyms, mcounts, dev)
        torch.cuda.synchronize()
        if int(seq[1].sum()) + int(match[1].sum()) < best:
            best = int(seq[1].sum()) + int(match[1].sum())
            flags = MATCH_USED
            alone["SEQ"], alone["MATCH"] = seq, match
    assert flags and blk.flags & MATCH_USED
    for name in ("SEQ", "QUAL", "MATCH"):
        assert np.array_equal(blk.streams[name].lane_lens, alone[name][1])
        assert np.array_equal(blk.streams[name].payload, alone[name][0])
    assert bytes(decode_block_finish(decode_block_device(blk, cfg, dev),
                                     cfg)) == data


def test_compact_kernel_ragged_chunks(dev):
    """Kernel C on chunk counts past CB (an overflowed optimistic buffer),
    across several 128-chunk tiles of one lane, at W = 64 and at W = 100
    (a lane group cut short), with rows longer than one shared-memory
    stage (staged in segments) and cut at Bmax = 100."""
    rng = np.random.default_rng(2)
    NC, CB = 1600, 32
    for W in (64, 100):
        eptrs = rng.integers(0, CB + 8, size=(NC, W)).astype(np.int32)
        eptrs[:, 3] = 0
        ebufs = rng.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
        eb, ep = (torch.from_numpy(x).to(dev) for x in (ebufs, eptrs))
        longest = int(eptrs.sum(axis=0).max())
        assert longest > STAGE_BYTES
        for Bmax in (longest, 100):
            k = CC.compact_lanes_dev(eb, ep, Bmax)
            p = CC.compact_lanes_plain(eb, ep, Bmax)
            for a, b in zip(k, p):
                assert torch.equal(a.cpu(), b.cpu())


STAGE_BYTES = 27904  # csrc/compact.cu SEG_MAX: a lane row staged at once
# (NC, W, CB, count cap, Bmax past the longest lane): W of 8, 64, 100 and
# 1024; NC not a multiple of the 128-chunk tile; counts above CB; an
# all-empty stream; rows longer than one stage
RAGGED = [(300, 8, 32, 40, 5), (129, 64, 48, 48, 0), (77, 100, 16, 24, 3),
          (800, 1024, 64, 4, 0), (5, 64, 16, 0, 1), (1600, 100, 32, 40, 9)]


def _ragged_streams(dev, seed=3):
    rng = np.random.default_rng(seed)
    streams = []
    for NC, W, CB, cap, extra in RAGGED:
        eptrs = rng.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
        eptrs[:, W // 3] = 0  # a lane of zeros
        ebufs = rng.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
        Bmax = max(int(eptrs.sum(axis=0).max()) + extra, 1)
        streams.append((torch.from_numpy(ebufs).to(dev),
                        torch.from_numpy(eptrs).to(dev), Bmax))
    assert max(b for _, _, b in streams) > STAGE_BYTES
    return streams


def test_compact_streams_kernel_matches_plain(dev):
    """One launch over the ragged mix, with a tail per stream, against
    compact_streams_plain: the whole flat buffer, byte for byte."""
    from slimfastq_tpu_torch.ops import _cuda
    streams = _ragged_streams(dev)
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev) - 9
             for _, ep, _ in streams]
    before = _cuda.launches["compact_lanes_dev"]
    flat, layout = CC.compact_streams_dev(streams, tails)
    assert _cuda.launches["compact_lanes_dev"] == before + 1
    want, wlayout = CC.compact_streams_plain(streams, tails)
    assert layout == wlayout
    assert torch.equal(flat.cpu(), want.cpu())


def test_block_streams_compacted_at_once_equal_alone(dev):
    """A level-4 block's coded streams (QUAL, SEQ, the match trials' SEQ
    and MATCH, the aux streams), as encode_block hands them to Kernel C:
    compacted in one launch, each equal to the stream compacted alone."""
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.pipeline_native import _coder_jobs, \
        prepare_block_fast
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    cfg = config_for_level(4, block_records=4096)
    data = synth_fastq(4096, read_len=100, seed=5, n_rate=0.001)
    idx, n = native.fastq_index(data)
    pre = prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0, n,
                             cfg)
    streams = []
    for name, kind, geom, item, _ in _coder_jobs(pre, cfg, dev):
        CB = ST._chunk_bytes(geom.depth, hard=False)
        ebufs, eptrs, _, emax = CT.lane_encode_blocks([item], kind, geom,
                                                      CB)[0]
        assert int(emax) <= CB
        streams.append((ebufs, eptrs,
                        max(int(eptrs.sum(dim=0).max()), 1)))
    assert len(streams) > 7  # the trials' SEQ and MATCH beside the rest
    flat, layout = CC.compact_streams_dev(streams)
    for (ebufs, eptrs, Bmax), (pay, tot, _) in zip(streams,
                                                   layout.views(flat)):
        alone, atot = CC.compact_lanes_dev(ebufs, eptrs, Bmax)
        assert torch.equal(pay.cpu(), alone.cpu())
        assert torch.equal(tot.cpu(), atot.cpu())


def test_main_path_round_trip_on_card(dev):
    """Blocks coded one at a time (window 1, the 64k-record default's
    case): the one-block launches only."""
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(3000, read_len=100, seed=3, var_len=True,
                       n_rate=0.01)
    _cuda.reset_launches()
    enc = api.encode_fastq(data, block_records=1024, window=1)
    assert api.decode_fastq(enc, window=1) == data
    assert api.decode_fastq(enc, device="cpu") == data
    assert all(_cuda.launches[k] > 0 for k in _cuda.launches)
    # every E and D launch carried one block
    for k in ("lane_encode", "lane_decode"):
        assert _cuda.descs[k] == _cuda.launches[k]
    _assert_one_run_a_set(_cuda)


def _assert_one_run_a_set(_cuda):
    """Every launch set of Kernel E was one enc_run call, and each of its
    phases launched once a slice of those calls."""
    assert _cuda.launches["encode_run"] == _cuda.launches["lane_encode"] > 0
    for k in ("rows", "touches", "sort", "entry_scan", "gather", "code"):
        assert _cuda.launches[f"encode_{k}"] == _cuda.descs["encode_run"]


# (level, kind, [(Sp, active lanes)], match-span flags) of ragged windows:
# blocks of different step counts, one with a single active lane, the
# level-3 SEQ collision case and level 4's match family
WINDOWS = {
    "seq-l3": (3, "seq", [(256, None), (512, 700), (128, 1), (384, None)],
               False),
    "qual-l3": (3, "qual", [(304, None), (104, 1), (512, 900)], False),
    "seq-l4-match": (4, "seq", [(256, None), (400, 700), (200, 1)], True),
    "byte": (3, "byte", [(256, None), (64, None), (512, None)], False),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_window_kernels_match_plain_and_single(dev, case):
    """Kernel E and D over a ragged window (one CTA a block, each its own
    step count and table) against their plain versions and against one
    launch per block, byte for byte; Kernel C's window launch over the
    window's outputs against its plain version."""
    from slimfastq_tpu_torch.ops import _cuda
    level, kind, blocks, match = WINDOWS[case]
    geom = _geom(level, kind)
    W = 64 if kind == "byte" else 1024
    rng = np.random.default_rng(4)
    streams = [_stream(kind, rng, dev, W, active, match=match, Sp=Sp)
               for Sp, active in blocks]
    items, counts = [], []
    for syms, cnt, pos, reset, mflag in streams:
        c = torch.from_numpy(cnt.astype(np.int32)).to(dev)
        items.append(CT.EncIn(syms, pos, reset, c, mflag))
        counts.append(c)
    CB = ST._chunk_bytes(geom.depth, False)
    before = _cuda.launches["lane_encode"], _cuda.descs["lane_encode"]
    ke = CT.lane_encode_blocks(items, kind, geom, CB)
    assert (_cuda.launches["lane_encode"], _cuda.descs["lane_encode"]) == (
        before[0] + 1, before[1] + len(items))
    pe = CT.lane_encode_blocks_plain(items, kind, geom, CB)
    for k, p, it in zip(ke, pe, items):
        one = CT.lane_encode(*it[:4], kind, geom, CB, it.mflag)
        for x, y, z in zip(k, p, one):
            assert torch.equal(x.cpu(), y.cpu())
            assert torch.equal(x.cpu(), z.cpu())
    comp = [(e[0], e[1], max(int(e[1].sum(dim=0).max()), 1)) for e in ke]
    tails = [e[2] for e in ke]
    assert torch.equal(CC.compact_streams_dev(comp, tails)[0].cpu(),
                       CC.compact_streams_plain(comp, tails)[0].cpu())
    items = []
    for (syms, cnt, pos, reset, mflag), e, c in zip(streams, ke, counts):
        assert int(e[3]) <= CB
        pay, tot = CC.compact_lanes_dev(e[0], e[1], max(int(
            e[1].sum(dim=0).max()), 1))
        pay, lens = ST._flush_append(pay.cpu().numpy(),
                                     tot.cpu().numpy().astype(np.int64),
                                     e[2].cpu().numpy().view(np.uint32), cnt)
        items.append((torch.from_numpy(pay).to(dev),
                      torch.from_numpy(lens.astype(np.int32)).to(dev),
                      c, pos, reset, mflag))
    kd = CT.lane_decode_blocks(items, kind, geom)
    pd = CT.lane_decode_blocks_plain(items, kind, geom)
    for k, p, it, (syms, *_), c in zip(kd, pd, items, streams, counts):
        assert torch.equal(k.cpu(), p.cpu())
        assert torch.equal(k.cpu(), CT.lane_decode(*it[:5], kind, geom,
                                                   it[5]).cpu())
        mask = torch.arange(syms.shape[0], device=dev)[:, None] < c[None, :]
        assert torch.equal(k[mask], syms[mask])


def test_compact_window_88_streams(dev):
    """Kernel C's window launch over 88 descriptors (a window of 8
    level-4 blocks with match trials codes 88 streams), past the 4 KB of
    classic kernel parameters, against its plain version."""
    from slimfastq_tpu_torch.ops import _cuda
    streams = []
    for seed in range(15):
        streams += _ragged_streams(dev, seed)[:6]
    streams = streams[:88]
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev)
             for _, ep, _ in streams]
    before = (_cuda.launches["compact_lanes_dev"],
              _cuda.descs["compact_lanes_dev"])
    flat, _ = CC.compact_streams_dev(streams, tails)
    assert (_cuda.launches["compact_lanes_dev"],
            _cuda.descs["compact_lanes_dev"]) == (before[0] + 1,
                                                   before[1] + 88)
    assert torch.equal(flat.cpu(),
                       CC.compact_streams_plain(streams, tails)[0].cpu())


@pytest.mark.parametrize("level", [3, 4])
def test_window_round_trip_on_card(dev, level):
    """Four 2,048-record blocks coded as one window: the container equals
    the one-block-at-a-time container, decodes exactly windowed and one
    block at a time, and the window's E and D launches carry several
    blocks and C runs once (at level 4 a block takes a match trial)."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(4 * 2048, read_len=100, seed=5, n_rate=0.001)
    kw = dict(level=level, block_records=2048)
    alone = api.encode_fastq(data, window=1, **kw)
    _cuda.reset_launches()
    enc = api.encode_fastq(data, **kw)
    assert api.decode_fastq(enc) == data
    # E and D launches carried several blocks; one C launch took the
    # window's streams, 7 or more a block
    for k in ("lane_encode", "lane_decode"):
        assert _cuda.descs[k] > _cuda.launches[k] > 0, _cuda.descs
    assert _cuda.launches["compact_lanes_dev"] == 1
    assert _cuda.descs["compact_lanes_dev"] >= 4 * 7
    _assert_one_run_a_set(_cuda)
    assert enc == alone
    assert api.decode_fastq(enc, window=1) == data
    if level == 4:
        f = io.BytesIO(enc)
        cfg = container.read_header(f)
        assert any(b.flags & MATCH_USED
                   for b in container.iter_blocks(f, cfg))


@pytest.mark.parametrize("level", [3, 4])
def test_host_pack_path_on_card(dev, level, monkeypatch):
    """Every block forced through the host-pack path (the port's _MAX_SPAN
    lowered to 1): the containers of the path on the card equal the main
    path's, and each decodes exactly through the host unpack; Kernel E
    coded each SEQ/QUAL stream whole, Kernel L made its step inputs and
    Kernel U did not run."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(2 * 2048, read_len=100, seed=5, n_rate=0.001)
    kw = dict(level=level, block_records=2048)
    want = api.encode_fastq(data, **kw)
    monkeypatch.setattr(PN, "_MAX_SPAN", 1)
    _cuda.reset_launches()
    enc = api.encode_fastq(data, **kw)
    assert _cuda.launches["lane_encode"] >= 2
    assert _cuda.launches["lane_layout"] >= 1
    assert enc == want
    _cuda.reset_launches()
    assert api.decode_fastq(enc) == data
    assert _cuda.launches["lane_unpack"] == 0
    if level == 4:
        f = io.BytesIO(enc)
        cfg = container.read_header(f)
        assert any(b.flags & MATCH_USED
                   for b in container.iter_blocks(f, cfg))


def _sharded_round_trip(devices, level: int = 3):
    """Four 2,048-record blocks through the sharded path on a mesh of
    ``devices`` (one window, split over the shards): the sequential
    container, decoded exactly; returns each shard's launches by card
    (_cuda.by_shard)."""
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import mesh as pmesh
    from slimfastq_tpu_torch.parallel import sharded
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(4 * 2048, read_len=100, seed=5, n_rate=0.001)
    cfg = config_for_level(level, block_records=2048)
    want = api.encode_fastq(data, cfg=cfg)
    mesh = pmesh.make_mesh(devices=devices)
    _cuda.reset_launches()
    assert sharded.encode_fastq_sharded(data, cfg, mesh=mesh) == want
    assert sharded.decode_fastq_sharded(want, mesh=mesh) == data
    return dict(_cuda.by_shard)


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0", "cuda:0"]],
                         ids=["one-card", "card-twice"])
def test_sharded_path_on_card(dev, devices):
    """The sharded path on a one-card mesh (one shard, on the calling
    thread) and on a mesh naming the card twice (two shard threads, two
    blocks each, each on its own CUDA stream): the sequential bytes; each
    shard launched E, D, C, L and U on the card."""
    by_shard = _sharded_round_trip(devices)
    assert set(by_shard) == {(i, "cuda:0") for i in range(len(devices))}
    for tally in by_shard.values():
        assert set(tally) == set(_cuda_names()), tally


def test_sharded_over_two_cards(dev):
    """The four blocks sharded over cuda:0 and cuda:1 (runs only on a node
    with two cards or more): the sequential bytes, and each shard's
    launches made on its own card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    by_shard = _sharded_round_trip(["cuda:0", "cuda:1"])
    assert set(by_shard) == {(0, "cuda:0"), (1, "cuda:1")}
    for tally in by_shard.values():
        assert set(tally) == set(_cuda_names()), tally


def _cuda_names() -> list:
    from slimfastq_tpu_torch.ops import _cuda
    return list(_cuda.launches)


@pytest.mark.parametrize("level", [3, 4])
def test_python_pipeline_on_card(dev, level):
    """use_native=False on the card: the pure-Python pipeline codes each
    stream with its own Kernel E and C launches (decode: D), the
    level-4 block's match trials and its MATCH_USED SEQ decode with the
    match-span flags; the container equals the CPU plain path's and the
    native path's, and decodes."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    # test_torch_api.py's window case: block 0 takes a match trial at L4
    data = synth_fastq(2 * 1030, read_len=100, seed=5, n_rate=0.001)
    kw = dict(level=level, block_records=1030)
    _cuda.reset_launches()
    enc = api.encode_fastq(data, use_native=False, **kw)
    assert api.decode_fastq(enc, use_native=False) == data
    assert all(_cuda.launches[k] > 0 for k in
               ("lane_encode", "lane_decode", "compact_lanes_dev"))
    assert enc == api.encode_fastq(data, device="cpu", use_native=False,
                                   **kw)
    assert enc == api.encode_fastq(data, **kw)
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
    assert bool(flags[0] & MATCH_USED) == (level == 4)


def test_wide_block_refused(dev):
    """Any lane count codes on the card (no plain version stands in), and
    so does a visit cap of 512 (32-bit entries), equal to the plain
    version on the CPU: nothing is refused."""
    geom = config_for_level(3).flags
    from slimfastq_tpu_torch.ops import _cuda
    for W in (1025, 4097, 65536):
        z = torch.zeros((8, W), dtype=torch.uint8, device=dev)
        c = torch.zeros(W, dtype=torch.int32, device=dev)
        _cuda.reset_launches()
        CT.lane_encode(z, None, None, c, "flag", geom, 16)
        assert _cuda.launches["lane_encode"] == 1
    warm = replace(config_for_level(3).seq, rate=14, rate_lo=1)
    rng = np.random.default_rng(5)
    syms, counts, pos, reset, _ = _stream("seq", rng, dev, 64)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    _cuda.reset_launches()
    got = CT.lane_encode(syms, pos, reset, c, "seq", warm, 16)
    assert _cuda.launches["lane_encode"] == 1
    want = CT.lane_encode(*(x.cpu() for x in (syms, pos, reset, c)), "seq",
                          warm, 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_entry_on_card(dev):
    """entry()'s flagship step on the card (Kernel E, launched once)
    equals the same step on the CPU (its plain version), byte for byte."""
    from slimfastq_tpu_torch import entry
    from slimfastq_tpu_torch.ops import _cuda
    fn, args = entry.entry()
    assert all(a.is_cuda for a in args)
    _cuda.reset_launches()
    got = fn(*args)
    assert _cuda.launches["lane_encode"] == 1
    fn_cpu, args_cpu = entry.entry(device="cpu")
    for a, b in zip(got, fn_cpu(*args_cpu)):
        assert torch.equal(a.cpu(), b)


def test_dryrun_multichip_on_cards(dev):
    """dryrun_multichip over every card: its three phases round-trip,
    every kernel launched."""
    from slimfastq_tpu_torch import entry
    from slimfastq_tpu_torch.ops import _cuda
    _cuda.reset_launches()
    out = entry.dryrun_multichip(torch.cuda.device_count())
    assert list(out) == ["toy", "production", "match"]
    assert all(_cuda.launches.values())


def _raw_block(n: int, W: int, seed: int, empty_lane: bool = False):
    """A synthetic block's padded raw bytes on the card with its SEQ/QUAL
    offsets, lengths (ragged, some 0: a record of length 0 sets no read
    start; with ``empty_lane`` every record of lane 1 is 0 long),
    lane-length matrix, lane counts and steps."""
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.pipeline import _lane_lengths_matrix
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(n, read_len=100, seed=seed, var_len=True,
                       n_rate=0.01)
    idx, _ = native.fastq_index(data)
    lengths = idx["seq_len"].astype(np.int64)
    lengths[::7] = 0  # the index keeps its offsets; the lanes skip them
    if empty_lane:
        lengths[1::W] = 0
    dpad = np.zeros(PT.pad_flat(len(data)), dtype=np.uint8)
    dpad[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    ll = _lane_lengths_matrix(lengths, W)
    counts = ll.sum(axis=0)
    return (dpad, idx["seq_off"], idx["qual_off"], lengths, ll, counts,
            int(counts.max()))


@pytest.mark.parametrize("n,W,empty_lane", [(65536, 1024, False),
                                            (5000, 1024, False),
                                            (300, 64, False),
                                            (7000, 1000, False),
                                            (3000, 96, True)])
def test_lane_layout_and_unpack_match_plain(dev, n, W, empty_lane):
    """Kernel L (pair mode: SEQ, QUAL, pos and reset in one launch;
    step-input mode: pos and reset) and Kernel U against their plain
    versions on the card (whole matrices, rows past a lane's count
    included), at W a multiple of 16 (vector stores) and not (W = 1000),
    with a lane whose records are all empty; U giving back the packed
    records' bytes."""
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.pipeline_native import (_BASE_TO_CODE_DEV,
                                                     _CODE_TO_BASE_FULL)
    dpad, soffs, qoffs, lengths, ll, counts, S = _raw_block(n, W, 11,
                                                            empty_lane)
    assert not empty_lane or counts[1] == 0
    Sp = pad_steps(S) + 8  # rows past every lane's count too
    d = torch.from_numpy(dpad).to(dev)
    before = _cuda.launches["lane_layout"]
    k = PT.lane_layout(d, soffs, qoffs, lengths, ll, W, Sp, S,
                       _BASE_TO_CODE_DEV, 33)
    assert _cuda.launches["lane_layout"] == before + 1
    p = (*PT.pack_pair_plain(d, soffs, qoffs, lengths, W, Sp,
                             _BASE_TO_CODE_DEV, 33),
         *PT._pos_reset(torch.from_numpy(ll).to(dev), Sp, S, W))
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pos, reset = PT.step_inputs(ll, Sp, S, W, dev)
    assert torch.equal(pos, p[2]) and torch.equal(reset, p[3])
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    before = _cuda.launches["lane_unpack"]
    ku = PT.unpack_pair(k[0], k[1], starts, lengths, W, total,
                        _CODE_TO_BASE_FULL, 33)
    assert _cuda.launches["lane_unpack"] == before + 1
    pu = PT.unpack_pair_plain(k[0], k[1], starts, lengths, W, total,
                              _CODE_TO_BASE_FULL, 33)
    for a, b in zip(ku, pu):
        assert a.shape == (total,) and torch.equal(a, b[:total])
    want_q = b"".join(bytes(dpad[o: o + L]) for o, L in zip(qoffs, lengths))
    assert bytes(ku[1][:total].cpu().numpy()) == want_q


@pytest.mark.parametrize("n,W", [(65536, 1024), (700, 1000), (90, 24)])
@pytest.mark.parametrize("aux", ["map", "bias"])
def test_single_stream_kernels_match_plain(dev, n, W, aux):
    """Kernel L's and U's single-stream modes (pack_device /
    unpack_device) against pack_device_plain / unpack_device_plain on
    whole arrays: the [Sp, W] matrix with its rows past a lane's count,
    the [pad_flat(total)] buffer with its bytes past the total; each
    launch counted under its kernel."""
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    dpad, _, qoffs, lengths, _, counts, S = _raw_block(n, W, 12)
    Sp = pad_steps(S) + 8
    d = torch.from_numpy(dpad).to(dev)
    rng = np.random.default_rng(n)
    kw = (dict(map256=rng.integers(0, 256, 256).astype(np.uint8))
          if aux == "map" else dict(bias=33))
    before = dict(_cuda.launches)
    k = PT.pack_device(d, qoffs, lengths, W, Sp, **kw)
    assert _cuda.launches["lane_layout"] == before["lane_layout"] + 1
    assert torch.equal(k, PT.pack_device_plain(d, qoffs, lengths, W, Sp,
                                               **kw))
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    back = dict(map256=np.arange(256, dtype=np.uint8)[::-1].copy()) \
        if aux == "map" else dict(bias=-7)
    u = PT.unpack_device(k, starts, lengths, W, total, **back)
    assert _cuda.launches["lane_unpack"] == before["lane_unpack"] + 1
    assert torch.equal(u, PT.unpack_device_plain(k, starts, lengths, W,
                                                 total, **back))


def test_host_buffers_reused_across_encodes(dev):
    """The page-locked raw-byte buffers (pack_torch.pinned_empty, from
    PyTorch's caching host allocator): two encodes of a 4-block set back
    to back give the same container (a buffer reused before its copy
    completed would change bytes), and the second allocates no new
    page-locked memory: it reuses the first's."""
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(4000, read_len=100, seed=5, var_len=True,
                       n_rate=0.01)
    kw = dict(level=3, device=dev, block_records=1000, window=2)
    assert torch.from_numpy(PT.pinned_empty(16)).is_pinned()
    first = api.encode_fastq(data, **kw)
    held = torch.cuda.host_memory_stats()["num_host_alloc"]
    assert held >= 1
    assert api.encode_fastq(data, **kw) == first
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == held
    assert api.decode_fastq(first, device=dev) == data


# (level, blocks [(Sp, lanes)], match-span flags) of Kernel D's cluster
# form on SEQ: "all" lanes hold reads that start at step 0 (every lane on
# one entry at each read start), an int n: n lanes chosen at random,
# spread over every CTA of the cluster (700 on one entry read a negative
# count); a ragged window of 4 blocks; level 4's match family
CLUSTER_CASES = {
    "seq-one-entry-1024": (3, [(256, "all")], False),
    "seq-one-entry-700-spread": (3, [(256, 700)], False),
    "seq-ragged-window-4": (3, [(304, "all"), (104, 1), (512, 700),
                                (200, "all")], False),
    "seq-l4-match-700-spread": (4, [(256, 700)], True),
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_cluster_decode_matches_plain(dev, case):
    """Kernel D with a SEQ stream's 1,024 lanes over a thread block
    cluster (the table and the law's counters in device memory) against
    lane_decode_blocks_plain, byte for byte, where the colliding lanes lie
    in every CTA of the cluster; one launch for the window."""
    level, blocks, match = CLUSTER_CASES[case]
    items, refs, spreads = _seq_blocks(level, blocks, match, 100, dev)
    geom, W = _geom(level, "seq"), 1024
    shape = CT.decode_shape(geom, W, len(blocks))
    assert shape.cluster == 8
    for on in spreads:
        if len(on) >= shape.cluster:
            assert len(set(on // shape.threads)) == shape.cluster
    _decode_window(items, refs, geom, dev)


def _seq_blocks(level, blocks, match, read_len, dev, seed=7):
    """SEQ blocks [(Sp, lanes)] at W = 1,024 encoded on the card: "all"
    lanes hold reads of `read_len` that start at step 0 (every lane on one
    entry at each read start), an int n: n lanes chosen at random; with
    `match`, the flagged steps' e-letters all 0 at positions 18-23. Returns
    Kernel D's items, (symbols, counts) of each and each block's lanes."""
    geom, W, kind = _geom(level, "seq"), 1024, "seq"
    rng = np.random.default_rng(seed)
    items, refs, spreads = [], [], []
    for Sp, lanes in blocks:
        on = (np.arange(W) if lanes == "all"
              else np.sort(rng.choice(W, lanes, replace=False)))
        spreads.append(on)
        ll = np.zeros((-(-Sp // read_len), W), dtype=np.int64)
        ll[:, on] = read_len
        ll[-1, on] = Sp - read_len * (ll.shape[0] - 1)
        counts = ll.sum(axis=0)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        syms = rng.integers(0, 4, size=(Sp, W))
        mflag = None
        if match:
            p = pos.cpu().numpy()
            span = (p >= 20) & (p < 90) & (np.arange(Sp)[:, None]
                                           < counts[None, :])
            syms = np.where(span, np.where(rng.random((Sp, W)) < 0.9, 0,
                                           syms), syms)
            syms[(p >= 18) & (p < 24)] = 0
            mflag = torch.from_numpy(span.astype(np.uint8)).to(dev)
        syms = torch.from_numpy(syms.astype(np.uint8)).to(dev)
        c = torch.from_numpy(counts.astype(np.int32)).to(dev)
        CB = ST._chunk_bytes(geom.depth, False)
        ebufs, eptrs, low, emax = CT.lane_encode(syms, pos, reset, c, kind,
                                                 geom, CB, mflag)
        assert int(emax) <= CB
        pay, tot = CC.compact_lanes_dev(ebufs, eptrs, max(int(
            eptrs.sum(dim=0).max()), 1))
        pay, lens = ST._flush_append(pay.cpu().numpy(),
                                     tot.cpu().numpy().astype(np.int64),
                                     low.cpu().numpy().view(np.uint32),
                                     counts)
        items.append((torch.from_numpy(pay).to(dev),
                      torch.from_numpy(lens.astype(np.int32)).to(dev), c,
                      pos, reset, mflag))
        refs.append((syms, c))
    return items, refs, spreads


def _decode_window(items, refs, geom, dev):
    """Kernel D's one launch over `items` against its plain version and
    the coded symbols."""
    from slimfastq_tpu_torch.ops import _cuda
    before = _cuda.launches["lane_decode"], _cuda.descs["lane_decode"]
    kd = CT.lane_decode_blocks(items, "seq", geom)
    assert (_cuda.launches["lane_decode"], _cuda.descs["lane_decode"]) == (
        before[0] + 1, before[1] + len(items))
    pd = CT.lane_decode_blocks_plain(items, "seq", geom)
    for k, p, (syms, c) in zip(kd, pd, refs):
        assert torch.equal(k.cpu(), p.cpu())
        mask = torch.arange(syms.shape[0], device=dev)[:, None] < c[None, :]
        assert torch.equal(k[mask], syms[mask])


@pytest.mark.parametrize("level,match", [(3, False), (4, True)])
def test_long_read_seq_decodes_over_the_cluster(dev, level, match):
    """SEQ of long reads over the cluster, as short reads: 1,024 lanes of
    1,500-base reads (a ragged window of two blocks, 700 lanes on one entry
    in the second) against the plain version, byte for byte."""
    items, refs, _ = _seq_blocks(level, [(3000, "all"), (1600, 700)],
                                 match, 1500, dev)
    geom = _geom(level, "seq")
    assert CT.decode_shape(geom, 1024, 2).cluster == 8
    _decode_window(items, refs, geom, dev)
