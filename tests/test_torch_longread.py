"""Long-read blocks on the CPU (the kernels' plain versions): the pieces of
the host-pack path, which a block whose raw bytes reach 2 GiB takes, held
against the JAX package at small sizes.

* encode_stream_ll / decode_stream_ll (pos/reset derived on the device
  from the lane lengths, Kernel E in one launch) give streams_jax's
  payloads and symbols (its test_ll_variants_match_oracle, ported);
* Kernel E's plain version (its rows built online) gives the bytes of
  the closed-form schedule's rows through the coder, on read layouts
  from ragged to one busy lane, also for level 1's QUAL and SEQ, whose
  tables the kernel keeps in shared memory;
* the host pack (native.pack_lanes) gives Kernel L's pack-mode symbols
  on an N-rich block, and pos/reset the reference's layout;
* the device-byte budget keeps today's windows and codes a long block
  alone.

The containers of the forced path (the port's _MAX_SPAN lowered) are
held against the JAX package's in tests/test_torch_longread_levels.py
and _l4.py, the window budget and the overflow rerun in
tests/test_torch_longread_windows.py.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from slimfastq_tpu.config import config_for_level as jconfig_for_level
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.pipeline import _scatter_record_symbols, _seq_symbol_layout
from slimfastq_tpu_torch import native
from slimfastq_tpu_torch import pipeline_native as TPN
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import pack_torch
from slimfastq_tpu_torch.ops import streams_torch as ST
from slimfastq_tpu_torch.ops.ranger import pad_steps
from slimfastq_tpu_torch.pipeline import (_BASE_TO_CODE,
                                          _lane_lengths_matrix)
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

W = 16


def _reads(seed: int, n: int = 100, hi: int = 60):
    """(lengths, ll_mat, counts, S, per-read qual-like symbols) of n reads
    of 0..hi-1 symbols at W lanes."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, hi, size=n).astype(np.int64)
    ll_mat = _lane_lengths_matrix(lengths, W)
    counts = ll_mat.sum(axis=0)
    recs = [np.clip(30 + np.cumsum(rng.integers(-2, 3, size=L)), 0,
                    63).astype(np.uint32) for L in lengths]
    return lengths, ll_mat, counts, int(counts.max()), recs


@pytest.mark.parametrize("kind", ["qual", "seq", "seq-mflag"])
def test_ll_variants_match_jax(kind, monkeypatch):
    """encode_stream_ll (one Kernel E launch over the whole stream) and
    decode_stream_ll give the payloads and symbols of the JAX package's
    streams_jax.encode_stream_ll / decode_stream_ll."""
    coded, fn = [], CT.lane_encode_blocks

    def spy(*args, **kw):  # the chunks each launch codes
        out = fn(*args, **kw)
        coded.extend(o[1].shape[0] for o in out)
        return out
    monkeypatch.setattr(CT, "lane_encode_blocks", spy)
    level = 4 if kind == "seq-mflag" else 3
    jcfg = jconfig_for_level(level, lanes=W, aux_lanes=8)
    cfg = config_for_level(level, lanes=W, aux_lanes=8)
    lengths, ll_mat, counts, S, recs = _reads(5)
    mflag = None
    if kind != "qual":
        recs = [r & 3 for r in recs]
        if kind == "seq-mflag":
            rng = np.random.default_rng(6)
            flags = [(rng.random(len(r)) < 0.4).astype(np.uint32)
                     for r in recs]
            mflag = _scatter_record_symbols(flags, W, S, counts).astype(
                np.uint8)
    syms = _scatter_record_symbols(recs, W, S, counts)
    k = kind.split("-")[0]
    jgeom, geom = (jcfg.qual, cfg.qual) if k == "qual" else (jcfg.seq,
                                                             cfg.seq)
    p_j, l_j = streams_jax.encode_stream_ll(k, jgeom, syms, ll_mat, counts,
                                            mflag=mflag)
    p_t, l_t = ST.encode_stream_ll(k, geom, syms, ll_mat, counts, "cpu",
                                   mflag=mflag)
    assert coded == [pad_steps(S) // 8]
    assert np.array_equal(l_t, l_j)
    assert np.array_equal(p_t, p_j)
    d_j = streams_jax.decode_stream_ll(k, jgeom, p_j, l_j, ll_mat, counts,
                                       S, mflag=mflag)
    d_t = ST.decode_stream_ll(k, geom, p_j, l_j, ll_mat, counts, S, "cpu",
                              mflag=mflag)
    assert np.array_equal(d_t, d_j)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(d_t[mask], syms[mask])


LAYOUTS = ["ragged", "zero-length", "one-lane", "long-reads"]


def _sched_inputs(kind: str, layout: str = "ragged"):
    """(geom, syms, pos, reset, counts, mflag) of a per-read stream at W
    lanes on the CPU (level-3 QUAL / SEQ; seq-mflag: level-4 SEQ with
    match-span flags; qual-l1 / seq-l1: level 1's, whose tables fit
    shared memory). Layouts: ragged reads of 0 to 59 symbols; a third of
    them of length 0; one lane with reads, the others empty; reads of 90
    to 120 symbols, each across several chunks."""
    level = {"seq-mflag": 4, "qual-l1": 1, "seq-l1": 1}.get(kind, 3)
    cfg = config_for_level(level, lanes=W, aux_lanes=8)
    seed = 7 + LAYOUTS.index(layout)
    rng = np.random.default_rng(seed)
    if layout == "ragged":
        lengths = rng.integers(0, 60, size=100)
    elif layout == "zero-length":
        lengths = rng.integers(1, 40, size=120) * (rng.random(120) > 1 / 3)
    elif layout == "one-lane":
        lengths = np.zeros(5 * W, dtype=np.int64)
        lengths[3::W] = rng.integers(1, 50, size=5)
    else:
        lengths = rng.integers(90, 121, size=2 * W)
    lengths = lengths.astype(np.int64)
    ll_mat = _lane_lengths_matrix(lengths, W)
    counts = ll_mat.sum(axis=0)
    S = int(counts.max())
    recs = [np.clip(30 + np.cumsum(rng.integers(-2, 3, size=L)), 0,
                    63).astype(np.uint32) for L in lengths]
    if geom_kind(kind) != "qual":
        recs = [r & 3 for r in recs]
    Sp = pad_steps(S)
    syms = ST._pad2(_scatter_record_symbols(recs, W, S, counts), Sp, W,
                    "cpu", torch.uint8)
    pos, reset = ST._pos_reset(ST._lane_lens(ll_mat, W, "cpu"), Sp, S, W)
    mflag = None
    if kind == "seq-mflag":
        mflag = torch.from_numpy((rng.random((Sp, W)) < 0.4).astype(
            np.uint8))
    geom = cfg.qual if geom_kind(kind) == "qual" else cfg.seq
    return geom, syms, pos, reset, torch.from_numpy(counts).int(), mflag


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["qual", "seq", "seq-mflag", "qual-l1",
                                  "seq-l1"])
def test_online_encode_equals_closed_form(kind, layout):
    """Kernel E's plain version, which builds each step's row online from
    the symbols before it as the kernel does, gives every byte, chunk
    count, final low and emax of the closed-form schedule's rows
    (streams_torch._schedule) through the same coder, and its rows equal
    them, also where the kernel keeps the table in shared memory (level
    1)."""
    geom, syms, pos, reset, counts, mflag = _sched_inputs(kind, layout)
    assert CT.table_in_smem(geom) == kind.endswith("-l1")
    k = geom_kind(kind)
    closed = ST._schedule(k, geom, syms, pos, reset, counts, mflag)
    item = CT.EncIn(syms, pos, reset, counts, mflag)
    online = CT.online_schedule(k, geom, item)
    assert torch.equal(online[0], closed[0])
    assert torch.equal(online[1], closed[1])
    CB = ST._chunk_bytes(geom.depth, hard=False)
    got = CT.lane_encode(syms, pos, reset, counts, k, geom, CB, mflag)
    for g, exp in zip(got, CT.lane_encode_plain(*closed, geom, CB)):
        assert torch.equal(g, exp)


def geom_kind(kind: str) -> str:
    return kind.split("-")[0]


def test_slices_refused_for_a_shared_memory_table():
    """A table that lives in shared memory codes in one launch with the
    others (the kernel builds it there, fresh; nothing carries it between
    launches). A depth-1 table that does not fit shared memory (FLAG at
    17 history bits; no level has one) takes Kernel D's device-memory
    shape, a fresh table a block. What the wrapper refuses: a launch of
    no blocks, and blocks of different lanes."""
    cfg = config_for_level(3, lanes=W, aux_lanes=8)
    counts = torch.full((W,), 16, dtype=torch.int32)
    z = CT.EncIn(torch.zeros((16, W), dtype=torch.uint8), None, None, counts)
    assert CT.table_in_smem(cfg.bytes_)
    outs = CT.lane_encode_blocks([z, z], "byte", cfg.bytes_, 64)
    assert [o[1].shape for o in outs] == [(2, W)] * 2
    wide = replace(cfg.flags, hist_bits=17)
    assert not CT.table_in_smem(wide)
    table, tally, _, shape = CT._kernel_geom(wide, W, torch.device("cpu"),
                                             2)
    assert (shape.table, shape.padded, shape.cluster, shape.smem_bytes) == (
        "device", False, 1, 0)
    assert table.shape == tally.shape == (2, wide.table_size)
    with pytest.raises(ValueError, match="blocks"):
        CT.lane_encode_blocks([], "byte", cfg.bytes_, 64)
    z8 = CT.EncIn(z.syms[:, :8], None, None, counts[:8])
    with pytest.raises(ValueError, match="same lanes"):
        CT.lane_encode_blocks([z, z8], "byte", cfg.bytes_, 64)


@pytest.mark.parametrize("lanes", [16, 128])
def test_host_pack_matches_device_pack(lanes):
    """On an N-rich block (n_rate 0.01) the host pack's SEQ lanes
    (native.pack_lanes with the map's 255 for non-ACGT, written as 0) and
    QUAL lanes (minus minq) equal Kernel L's pack mode's
    (pack_torch.lane_layout, its plain version) with _BASE_TO_CODE_DEV,
    and its non-ACGT census equals scan_bad's."""
    data = synth_fastq(300, read_len=40, seed=2, var_len=True, n_rate=0.01)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    lengths = idx["seq_len"].astype(np.int64)
    ll_mat = _lane_lengths_matrix(lengths, lanes)
    S = int(ll_mat.sum(axis=0).max())
    minq, _ = native.minmax_ranges(buf, idx["qual_off"], lengths)
    sq, _, nbad, rec_bad = native.pack_lanes(buf, idx["seq_off"], lengths,
                                             lanes, S, map256=_BASE_TO_CODE,
                                             dtype=np.uint8)
    qs = native.pack_lanes(buf, idx["qual_off"], lengths, lanes, S,
                           bias=minq, dtype=np.uint8)[0]
    assert nbad > 0
    nbad2, rec_bad2 = native.scan_bad(buf, idx["seq_off"], lengths)
    assert nbad == nbad2 and np.array_equal(rec_bad, rec_bad2)
    dpad = np.zeros(pack_torch.pad_flat(len(buf)), dtype=np.uint8)
    dpad[: len(buf)] = buf
    s_dev, q_dev, _, _ = pack_torch.lane_layout(
        torch.from_numpy(dpad), idx["seq_off"], idx["qual_off"], lengths,
        ll_mat, lanes, pad_steps(S), S, TPN._BASE_TO_CODE_DEV, minq)
    counts = ll_mat.sum(axis=0)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(s_dev[:S].numpy()[mask], sq[mask])
    assert np.array_equal(q_dev[:S].numpy()[mask], qs[mask])


def test_pos_reset_matches_reference_layout():
    """streams_torch._pos_reset (int32 scatter + running sum, no [Sp, W]
    int64 temporary) gives the reference layout's pos/reset, zero-length
    reads included."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 30, size=200) * (rng.random(200) < 0.8)
    lengths = lengths.astype(np.int64)
    _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
    ll_mat = _lane_lengths_matrix(lengths, W)
    p, r = ST._pos_reset(ST._lane_lens(ll_mat, W, "cpu"), pad_steps(S), S,
                         W)
    mask = np.arange(S)[:, None] < counts[None, :]
    assert np.array_equal(p[:S].numpy()[mask], pos[mask])
    assert np.array_equal(r[:S].numpy()[mask], reset[mask])


def test_budget_keeps_todays_windows_and_slices_long_reads():
    """The byte rule at the main path's geometry (W = 1024): four 65,536
    x 100 bp level-4 blocks with both match trials (a window of 4) and
    eight 16,384 x 100 bp blocks (a window of 8) stay far below 40 GB,
    half of an 80 GB card's free bytes, so their windows do not change; a
    65,536 x 16.5 kb block (Kernel E's inputs and chunk buffers, no
    schedule: 24.9 GB at level 3) passes half that budget and codes in a
    window of its own: two such blocks take two windows."""
    budget = 40 << 30
    big = ST.encode_bytes(pad_steps(6400), 1024, [6, 2, 2, 2])
    small = ST.encode_bytes(pad_steps(1600), 1024, [6, 2, 2, 2])
    assert 4 * big < budget // 8 and 8 * small < budget // 8
    NC = pad_steps(65536 // 1024 * 16500) // 8
    long_block = ST.encode_bytes(8 * NC, 1024, [6, 2])
    assert budget // 2 < long_block < budget < 2 * long_block
    assert ST.split_by_bytes([long_block] * 2, budget) == [[0], [1]]
    assert ST.split_by_bytes([3, 3, 5, 1, 9, 1], 6) == [[0, 1], [2, 3], [4],
                                                        [5]]
