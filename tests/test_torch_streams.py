"""The port's stream drivers (slimfastq_tpu_torch.ops.streams_torch) on the
CPU against the JAX package: the cases of tests/test_jax_equivalence.py,
with payloads and lane lengths equal to streams_jax's and to the NumPy
oracle's, and decode equal; and the device-raw SEQ+QUAL drivers against
streams_jax's on a raw block."""

import numpy as np
import pytest
import torch

from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import pack_jax, streams_jax, streams_np
from slimfastq_tpu.pipeline import _scatter_record_symbols, \
    _seq_symbol_layout
from slimfastq_tpu.pipeline_native import _BASE_TO_CODE_DEV, \
    _CODE_TO_BASE_FULL
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import native as tnative
from slimfastq_tpu_torch.ops import coder_torch, streams_torch
from slimfastq_tpu_torch.ops.ranger import pad_steps

torch.set_num_threads(1)


def _compare_stream(kind, geom, syms, counts, pos=None, reset=None):
    p_np, l_np = streams_np.encode_stream(kind, geom, syms, counts,
                                          pos=pos, reset=reset)
    p_jx, l_jx = streams_jax.encode_stream(kind, geom, syms, counts,
                                           pos=pos, reset=reset)
    p_t, l_t = streams_torch.encode_stream(kind, geom, syms, counts, "cpu",
                                           pos=pos, reset=reset)
    assert np.array_equal(l_t, l_jx) and np.array_equal(l_t, l_np)
    assert np.array_equal(p_t, p_jx) and np.array_equal(p_t, p_np)
    S = syms.shape[0]
    d_jx = streams_jax.decode_stream(kind, geom, p_np, l_np, counts, S,
                                     pos=pos, reset=reset)
    d_t = streams_torch.decode_stream(kind, geom, p_np, l_np, counts, S,
                                      "cpu", pos=pos, reset=reset)
    assert np.array_equal(d_t, d_jx)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(d_t[mask], syms[mask])


@pytest.fixture(scope="module")
def cfg():
    return config_for_level(2, lanes=16, aux_lanes=8)


def _ragged(rng, S, W, hi):
    counts = rng.integers(0, S + 1, size=W)
    counts[0] = 0
    counts[-1] = S
    syms = rng.integers(0, hi, size=(S, W)).astype(np.uint32)
    return syms, counts


def _read_layout(rng, n, W, maxlen):
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int64)
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    return lengths, counts, S, pos, reset


def test_byte_stream(cfg):
    rng = np.random.default_rng(0)
    syms, counts = _ragged(rng, 150, 8, 256)
    _compare_stream("byte", cfg.bytes_, syms, counts)


def test_flag_stream(cfg):
    rng = np.random.default_rng(1)
    syms, counts = _ragged(rng, 500, 8, 2)
    _compare_stream("flag", cfg.flags, syms, counts)


def test_seq_stream(cfg):
    rng = np.random.default_rng(2)
    W = cfg.lanes
    lengths, counts, S, pos, reset = _read_layout(rng, 100, W, 60)
    recs = [rng.integers(0, 4, size=L).astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("seq", cfg.seq, syms, counts, pos=pos, reset=reset)


def test_qual_stream(cfg):
    rng = np.random.default_rng(3)
    W = cfg.lanes
    lengths, counts, S, pos, reset = _read_layout(rng, 60, W, 60)
    recs = [np.clip(38 + np.cumsum(rng.integers(-2, 3, size=L)), 0, 63)
            .astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg.qual, syms, counts, pos=pos, reset=reset)


def test_qual_adversarial_constant(cfg):
    W = cfg.lanes
    lengths = np.full(64, 40, dtype=np.int64)
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    recs = [np.full(40, 30, dtype=np.uint32) for _ in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg.qual, syms, counts, pos=pos, reset=reset)


def test_qual_production_geometry_w128():
    """W = 128 lanes with the true level-3 quality geometry."""
    cfg3 = config_for_level(3, lanes=128, aux_lanes=8)
    rng = np.random.default_rng(21)
    W = 128
    lengths, counts, S, pos, reset = _read_layout(rng, 300, W, 80)
    recs = [np.clip(38 + np.cumsum(rng.integers(-3, 4, size=L)), 0, 63)
            .astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    _compare_stream("qual", cfg3.qual, syms, counts, pos=pos, reset=reset)


def test_empty_streams(cfg):
    z = np.zeros((0, 8), dtype=np.uint32)
    p, lens = streams_torch.encode_stream("byte", cfg.bytes_, z,
                                          np.zeros(8, np.int64), "cpu")
    assert p.shape == (8, 0) and not lens.any()
    d = streams_torch.decode_stream("byte", cfg.bytes_, p, lens,
                                    np.zeros(8, np.int64), 0, "cpu")
    assert d.shape == (0, 8)


def _spans_mflag(rng, lengths, W, S):
    """[S, W] match-span flags of random spans over half the records
    (native.match_mflag, as a v5 block builds them)."""
    n = len(lengths)
    recs = np.sort(rng.choice(n, size=n // 2, replace=False)).astype(
        np.int64)
    L = lengths[recs]
    los = (rng.random(len(recs)) * L // 2).astype(np.int64)
    his = np.maximum(los, L - (rng.random(len(recs)) * L // 4).astype(
        np.int64))
    return tnative.match_mflag(recs, los, his, lengths, W, S)


def test_seq_mflag_decode_matches_jax():
    """Kernel D's plain version with the match-context family against
    streams_jax.decode_stream(mflag=) on a payload streams_jax coded with
    the same flags (level 4 SEQ)."""
    cfg = config_for_level(4, lanes=16, aux_lanes=8)
    rng = np.random.default_rng(5)
    W = cfg.lanes
    lengths, counts, S, pos, reset = _read_layout(rng, 64, W, 60)
    recs = [rng.integers(0, 4, size=L).astype(np.uint32) for L in lengths]
    syms = _scatter_record_symbols(recs, W, S, counts)
    mflag = _spans_mflag(rng, lengths, W, S)
    assert mflag.any()
    p, lens = streams_jax.encode_stream("seq", cfg.seq, syms, counts,
                                        pos=pos, reset=reset, mflag=mflag)
    want = streams_jax.decode_stream("seq", cfg.seq, p, lens, counts, S,
                                     pos=pos, reset=reset, mflag=mflag)
    Sp = pad_steps(S)
    mf = np.zeros((Sp, W), dtype=np.uint8)
    mf[:S] = mflag
    got = coder_torch.lane_decode_plain(
        streams_torch._payload_tensor(p, "cpu"),
        torch.from_numpy(lens.astype(np.int32)),
        torch.from_numpy(counts.astype(np.int32)),
        *(streams_torch._pad2(x, Sp, W, "cpu") for x in (pos, reset)),
        "seq", cfg.seq, torch.from_numpy(mf)).numpy()[:S]
    assert np.array_equal(got, want)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(got[mask], syms[mask])


def test_seq_qual_raw_matches_jax():
    """The device-raw SEQ+QUAL drivers (lane pack, pos/reset, schedule,
    coder, compaction, flush) against streams_jax's on one raw block,
    and their decode + unpack back to the record bytes."""
    _raw_block_matches_jax(3)


def test_seq_qual_raw_match_trial_matches_jax():
    """Level 4: the same, then SEQ re-coded alone with match-span flags,
    as a v5 trial codes it, and decoded with the flags."""
    _raw_block_matches_jax(4)


def _raw_block_matches_jax(level):
    cfg = config_for_level(level, lanes=16, aux_lanes=8)
    data = synth_fastq(48, read_len=40, seed=4, var_len=True, n_rate=0.01)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = tnative.fastq_index(data)  # host.cpp: the same in both packages
    lengths = idx["seq_len"].astype(np.int64)
    W = cfg.lanes
    ll = np.zeros(((n + W - 1) // W) * W, dtype=np.int64)
    ll[:n] = lengths
    ll = ll.reshape(-1, W)
    counts = ll.sum(axis=0)
    minq, maxq = tnative.minmax_ranges(buf, idx["qual_off"], lengths)
    qgeom = cfg.qual
    dpad = np.zeros(pack_jax.pad_flat(len(buf)), dtype=np.uint8)
    dpad[: len(buf)] = buf
    args = (dpad, idx["seq_off"], idx["qual_off"], lengths, W,
            _BASE_TO_CODE_DEV, minq, ll, counts)
    jx = streams_jax.encode_seq_qual_raw(cfg.seq, qgeom, *args, padded=True)
    tt = streams_torch.encode_seq_qual_raw(cfg.seq, qgeom, *args, "cpu")
    for name in ("SEQ", "QUAL"):
        assert np.array_equal(tt[name][1], jx[name][1])
        assert np.array_equal(tt[name][0], jx[name][0])
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    S = int(counts.max())
    dargs = (tt["SEQ"][0], tt["SEQ"][1], tt["QUAL"][0], tt["QUAL"][1], ll,
             counts, S, starts, lengths, total, _CODE_TO_BASE_FULL, minq)
    js, jq = streams_jax.decode_seq_qual_raw(cfg.seq, qgeom, *dargs)
    ts, tq = streams_torch.decode_seq_qual_raw(cfg.seq, qgeom, *dargs, "cpu")
    assert np.array_equal(ts, js) and np.array_equal(tq, jq)
    want_q = np.concatenate([buf[o: o + L] for o, L in
                             zip(idx["qual_off"], lengths)])
    assert np.array_equal(tq, want_q)
    if level == 3:
        return
    mflag = _spans_mflag(np.random.default_rng(6), lengths, W, S)
    jx = streams_jax.encode_seq_qual_raw(cfg.seq, qgeom, *args, padded=True,
                                         seq_mflag=mflag, only=("SEQ",))
    tt = streams_torch.encode_seq_qual_raw(cfg.seq, qgeom, *args, "cpu",
                                           seq_mflag=mflag, only=("SEQ",))
    assert list(tt) == ["SEQ"]
    assert np.array_equal(tt["SEQ"][1], jx["SEQ"][1])
    assert np.array_equal(tt["SEQ"][0], jx["SEQ"][0])
    assert not np.array_equal(tt["SEQ"][0], dargs[0][: len(tt["SEQ"][0])])
    dargs = (tt["SEQ"][0], tt["SEQ"][1]) + dargs[2:]
    js, _ = streams_jax.decode_seq_qual_raw(cfg.seq, qgeom, *dargs,
                                            seq_mflag=mflag)
    ts, tq = streams_torch.decode_seq_qual_raw(cfg.seq, qgeom, *dargs, "cpu",
                                               seq_mflag=lambda: mflag)
    assert np.array_equal(ts, js) and np.array_equal(tq, want_q)
