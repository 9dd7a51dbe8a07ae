"""Kernels E, D and C against their plain PyTorch versions on a CUDA card,
byte for byte, on each table placement (shared memory, device memory),
with and without the visit warm-up, at the collision counts where the
format's count field wraps, and with the level-4 match-context family and
q1-q2 delta; a block (also a level-4 block with match trials) coded
with its streams at once against the same block coded one stream at a
time; Kernels E and D over a ragged window of blocks against their plain
versions and against one launch per block; Kernel C's one launch over
many streams (also a window's 88) against its plain version and against
each stream compacted alone; the small-block window path end to end;
Kernel E in step slices against one launch (also where the table lives
in shared memory, level 1); the host-pack path (forced on small blocks)
against the main path's containers; and the sharded path on a mesh of
one card, of the card named twice, and (with two cards or more) of two
cards, against the sequential containers; the pure-Python pipeline
(``use_native=False``) stream by stream on the card.
Marked `cuda`: they
skip without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch and a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

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
    return (torch.from_numpy(syms.astype(np.int32)).to(dev), counts, pos,
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
    "seq-l1": (1, "seq", 1024, False, None, None, True, False),
    "qual-l1": (1, "qual", 1024, False, None, None, True, False),
    "byte": (3, "byte", 64, False, None, None, True, False),
    "flag": (3, "flag", 64, False, None, None, True, False),
    "seq-l4-match-1024": (4, "seq", 1024, False, None, None, False, True),
    "seq-l4-match-700": (4, "seq", 1024, False, 700, None, False, True),
    "qual-l4": (4, "qual", 1024, False, None, None, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coder_and_compact_kernels_match_plain(dev, case):
    level, kind, W, hard, active, depth, smem, match = CASES[case]
    geom = _geom(level, kind, depth)
    assert CT.table_in_smem(geom, W) == smem
    rng = np.random.default_rng(1)
    syms, counts, pos, reset, mflag = _stream(kind, rng, dev, W, active,
                                              hi=1 << (depth or 6),
                                              match=match)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    idx_c, bit_c = ST._schedule(kind, geom, syms, pos, reset, c, mflag)
    CB = ST._chunk_bytes(geom.depth, hard)
    ke = CT.lane_encode(idx_c, bit_c, geom, CB)
    pe = CT.lane_encode_plain(idx_c, bit_c, geom, CB)
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
            ST._acts(c, Sp), pos, reset)
    kd = CT.lane_decode(*args, kind, geom, mflag)
    pd = CT.lane_decode_plain(*args, kind, geom, mflag)
    assert torch.equal(kd.cpu(), pd.cpu())
    mask = torch.arange(Sp, device=dev)[:, None] < c[None, :]
    assert torch.equal(kd[mask].int(), syms[mask])


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
    for name, kind, geom, idx_c, bit_c, _ in _coder_jobs(pre, cfg, dev):
        CB = ST._chunk_bytes(geom.depth, hard=False)
        ebufs, eptrs, _, emax = CT.lane_encode(idx_c, bit_c, geom, CB)
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
    scheds, counts = [], []
    for syms, cnt, pos, reset, mflag in streams:
        c = torch.from_numpy(cnt.astype(np.int32)).to(dev)
        scheds.append(ST._schedule(kind, geom, syms, pos, reset, c, mflag))
        counts.append(c)
    CB = ST._chunk_bytes(geom.depth, False)
    before = _cuda.launches["lane_encode"], _cuda.descs["lane_encode"]
    ke = CT.lane_encode_blocks(scheds, geom, CB)
    assert (_cuda.launches["lane_encode"], _cuda.descs["lane_encode"]) == (
        before[0] + 1, before[1] + len(scheds))
    pe = CT.lane_encode_blocks_plain(scheds, geom, CB)
    for k, p, (i, b) in zip(ke, pe, scheds):
        one = CT.lane_encode(i, b, geom, CB)
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
                      ST._acts(c, syms.shape[0]), pos, reset, mflag))
    kd = CT.lane_decode_blocks(items, kind, geom)
    pd = CT.lane_decode_blocks_plain(items, kind, geom)
    for k, p, it, (syms, *_), c in zip(kd, pd, items, streams, counts):
        assert torch.equal(k.cpu(), p.cpu())
        assert torch.equal(k.cpu(), CT.lane_decode(*it[:5], kind, geom,
                                                   it[5]).cpu())
        mask = torch.arange(syms.shape[0], device=dev)[:, None] < c[None, :]
        assert torch.equal(k[mask].int(), syms[mask])


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
    assert enc == alone
    assert api.decode_fastq(enc, window=1) == data
    if level == 4:
        f = io.BytesIO(enc)
        cfg = container.read_header(f)
        assert any(b.flags & MATCH_USED
                   for b in container.iter_blocks(f, cfg))


@pytest.mark.parametrize("case", ["qual-d6", "seq-collide-700",
                                  "seq-l4-match-1024", "qual-l1", "seq-l1"])
def test_sliced_encode_equals_unsliced(dev, case):
    """Kernel E in step slices (1, 2, 3 and uneven; the table, low and
    range carried from one launch to the next, each slice ending with its
    last bit-step's commit; a table in shared memory loaded from and
    stored to device memory at a slice's ends) gives the one launch's
    bytes, chunk counts, low and emax at W = 1024; lane_encode_sliced
    too; and its plain version over the same slices gives them as
    well."""
    from slimfastq_tpu_torch.ops import _cuda
    level, kind, W, hard, active, depth, smem, match = CASES[case]
    geom = _geom(level, kind, depth)
    assert CT.table_in_smem(geom, W) == smem
    rng = np.random.default_rng(4)
    syms, counts, pos, reset, mflag = _stream(kind, rng, dev, W, active,
                                              match=match, Sp=1024)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    CB = ST._chunk_bytes(geom.depth, hard)
    want = CT.lane_encode(*ST._schedule(kind, geom, syms, pos, reset, c,
                                        mflag), geom, CB)
    sl = ST.Slices(kind, geom, syms, pos, reset, c, mflag)
    NC = sl.NC
    for bounds in ([0, NC], [0, NC // 2, NC], [0, 40, 80, NC],
                   [0, 1, 7, 61, NC - 1, NC]):
        carry = CT.EncCarry()
        out = (torch.zeros((NC, W, CB), dtype=torch.uint8, device=dev),
               torch.zeros((NC, W), dtype=torch.int32, device=dev))
        before = _cuda.slices["lane_encode"]
        for c0, c1 in zip(bounds, bounds[1:]):
            (_, _, low, emax), = CT.lane_encode_blocks(
                [sl(c0, c1)], geom, CB, [carry],
                [(out[0][c0:c1], out[1][c0:c1])])
        assert _cuda.slices["lane_encode"] == before + len(bounds) - 1
        for got, exp in zip((*out, low, emax), want):
            assert torch.equal(got, exp)
    for got, exp in zip(CT.lane_encode_sliced(sl, NC, 37, W, geom, CB, dev),
                        want):
        assert torch.equal(got, exp)
    # the plain version over slices, on the first 48 chunks
    part = ST.Slices(kind, geom, syms[:384], pos[:384], reset[:384], c,
                     None if mflag is None else mflag[:384])
    k = CT.lane_encode_sliced(part, 48, 20, W, geom, CB, dev)
    carry = CT.EncCarry()
    p_out = (torch.zeros((48, W, CB), dtype=torch.uint8),
             torch.zeros((48, W), dtype=torch.int32))
    for c0 in (0, 20, 40):
        c1 = min(48, c0 + 20)
        (_, _, low, emax), = CT.lane_encode_blocks_plain(
            [tuple(x.cpu() for x in part(c0, c1))], geom, CB, [carry],
            [(p_out[0][c0:c1], p_out[1][c0:c1])])
    for got, exp in zip(k, (*p_out, low, emax)):
        assert torch.equal(got.cpu(), exp)


@pytest.mark.parametrize("level", [3, 4])
def test_host_pack_path_on_card(dev, level, monkeypatch):
    """Every block forced through the host-pack path (the port's _MAX_SPAN
    lowered to 1; step slices of 5 QUAL chunks): the containers of the
    path on the card equal the main path's, and each decodes exactly
    through the host unpack; Kernel E ran in slices."""
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
    monkeypatch.setattr(ST, "SLICE_BYTES", 5 * 2 * 4 * 8 * 6 * 1024)
    _cuda.reset_launches()
    enc = api.encode_fastq(data, **kw)
    assert _cuda.slices["lane_encode"] > 0
    assert enc == want
    assert api.decode_fastq(enc) == data
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
    shard launched E, D and C on the card."""
    by_shard = _sharded_round_trip(devices)
    assert set(by_shard) == {(i, "cuda:0") for i in range(len(devices))}
    for tally in by_shard.values():
        assert set(tally) == {"lane_encode", "lane_decode",
                              "compact_lanes_dev"}, tally


def test_sharded_over_two_cards(dev):
    """The four blocks sharded over cuda:0 and cuda:1 (runs only on a node
    with two cards or more): the sequential bytes, and each shard's
    launches made on its own card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    by_shard = _sharded_round_trip(["cuda:0", "cuda:1"])
    assert set(by_shard) == {(0, "cuda:0"), (1, "cuda:1")}
    for tally in by_shard.values():
        assert set(tally) == {"lane_encode", "lane_decode",
                              "compact_lanes_dev"}, tally


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
    geom = config_for_level(3).flags
    z = torch.zeros((1, 8, 2048), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        CT.lane_encode(z, z, geom, 16)
    warm = replace(config_for_level(3).seq, rate=14, rate_lo=1)
    z = torch.zeros((1, 16, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="visit cap"):
        CT.lane_encode(z, z, warm, 16)
