"""The device programs written by hand for Hopper in this slice, through
their plain versions on the CPU, against the JAX package's programs, with
inputs made from a seed with numpy; tolerance 0 (every output is an
integer):

* Kernel E from the symbols: coder_torch.lane_encode (its plain version
  builds each step's context online, as the kernel does, then codes)
  against streams_jax._build_schedule + _build_encode, for every kind: QUAL
  at level 3 and at level 4 (q2, delta and pos bits), SEQ at level 3 and
  at level 4 with match flags, byte and flag; with read resets, ragged
  counts and zero-length reads;
* Kernel L's pack mode (pack_torch.lane_layout) against
  pack_jax._build_pack_pair + streams_jax._pos_reset_device on the active
  rows, with ragged and zero-length records; its step-input mode
  (pack_torch.step_inputs) against _pos_reset_device;
* Kernel U (pack_torch.unpack_pair) against pack_jax._build_unpack_pair;
* the streaming encode from a pipe (a FIFO: nothing seeks), alone and on
  a one-entry CPU mesh, gives the whole-file container across chunk
  edges.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu.config import config_for_level as jconfig_for_level
from slimfastq_tpu.ops import pack_jax as PJ
from slimfastq_tpu.ops import streams_jax as SJ
from slimfastq_tpu.pipeline import _seq_symbol_layout
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import pack_torch as PT
from slimfastq_tpu_torch.ops.ranger import pad_steps
from slimfastq_tpu_torch.parallel import mesh as tmesh
from slimfastq_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(1)

W = 24


def _reads(rng, n: int, maxlen: int, zero: float = 0.1):
    """Random read lengths, some of them 0."""
    lengths = rng.integers(1, maxlen + 1, size=n)
    lengths[rng.random(n) < zero] = 0
    return lengths.astype(np.int64)


def _stream(case: str, rng):
    """(kind, level, syms [S, W], counts, pos, reset, mflag or None) of one
    stream: a per-read layout for qual/seq (resets at every read start,
    zero-length reads, ragged lanes), ragged counts for byte/flag."""
    kind, level = {"qual-l3": ("qual", 3), "qual-l4": ("qual", 4),
                   "seq-l3": ("seq", 3), "seq-l4-mflag": ("seq", 4),
                   "byte": ("byte", 3), "flag": ("flag", 3)}[case]
    if kind in ("qual", "seq"):
        lengths = _reads(rng, 9 * W, 37)
        _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
        if kind == "qual":  # a random walk: deltas of every class
            syms = np.clip(20 + np.cumsum(rng.integers(-4, 5, (S, W)),
                                          axis=0), 0, 63)
        else:
            syms = rng.integers(0, 4, size=(S, W))
    else:
        S = 200
        counts = rng.integers(0, S + 1, size=W)
        counts[0], counts[-1] = 0, S
        syms = rng.integers(0, 256 if kind == "byte" else 2, size=(S, W))
        pos = reset = None
    mflag = None
    if case == "seq-l4-mflag":
        mflag = (rng.random((S, W)) < 0.4).astype(np.uint8)
    return kind, level, syms.astype(np.uint32), counts, pos, reset, mflag


def _geoms(kind: str, level: int):
    names = {"qual": "qual", "seq": "seq", "byte": "bytes_", "flag": "flags"}
    return (getattr(jconfig_for_level(level), names[kind]),
            getattr(config_for_level(level), names[kind]))


CASES = ["qual-l3", "qual-l4", "seq-l3", "seq-l4-mflag", "byte", "flag"]


@pytest.mark.parametrize("case", CASES)
def test_encode_from_symbols_matches_jax(case):
    """Kernel E's plain version on the symbols (contexts online, as the
    kernel builds them) gives _build_schedule + _build_encode's chunk
    bytes, chunk counts, final low and emax; its online schedule equals
    _build_schedule's."""
    rng = np.random.default_rng(CASES.index(case))
    kind, level, syms, counts, pos, reset, mflag = _stream(case, rng)
    jgeom, geom = _geoms(kind, level)
    S = syms.shape[0]
    Sp = pad_steps(S)
    args = [SJ._pad2(x, Sp, W) for x in (syms, pos, reset)]
    mf = [] if mflag is None else [SJ._pad2(mflag, Sp, W)]
    j_idx, j_bit = (np.asarray(x) for x in SJ._build_schedule(
        kind, jgeom, Sp, W, with_mflag=bool(mf))(
            *(jnp.asarray(a) for a in args),
            jnp.asarray(counts.astype(np.int32)),
            *(jnp.asarray(m) for m in mf)))
    CB = SJ._chunk_bytes(jgeom.depth, False)
    eb, ep, lo, em = (np.asarray(x) for x in SJ._build_encode(
        kind, jgeom, Sp, W, False)(jnp.asarray(j_idx), jnp.asarray(j_bit)))
    item = CT.EncIn(torch.from_numpy(args[0].astype(np.uint8)),
                    *(torch.from_numpy(a.astype(np.int32)) for a in args[1:]),
                    torch.from_numpy(counts.astype(np.int32)),
                    *(torch.from_numpy(m.astype(np.uint8)) for m in mf))
    o_idx, o_bit = CT.online_schedule(kind, geom, item)
    assert np.array_equal(o_idx.numpy(), j_idx)
    assert np.array_equal(o_bit.numpy(), j_bit)
    NC = Sp // CT.CHUNK_SYMS
    want = (eb.reshape(NC, W, CB), ep, lo, int(em))
    got = CT.lane_encode(*item[:4], kind, geom, CB, item.mflag)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy().view(np.uint32), want[2])
    assert int(got[3]) == want[3]


def _block(rng, n: int):
    """A raw block's padded bytes and per-record SEQ/QUAL offsets and
    lengths (ragged, some 0): each record's bases then its qualities."""
    lengths = _reads(rng, n, 29, zero=0.15)
    parts, soffs, qoffs, at = [], [], [], 0
    for L in lengths:
        seq = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=L)
        qual = rng.integers(35, 75, size=L).astype(np.uint8)
        soffs.append(at + 1)
        qoffs.append(at + 2 + L)
        parts += [b"@", seq.tobytes(), b"\n", qual.tobytes(), b"\n"]
        at += 3 + 2 * L
    raw = np.frombuffer(b"".join(parts), dtype=np.uint8)
    dpad = np.zeros(PT.pad_flat(len(raw)), dtype=np.uint8)
    dpad[: len(raw)] = raw
    return (dpad, np.array(soffs, dtype=np.int64),
            np.array(qoffs, dtype=np.int64), lengths)


SEQ_MAP = np.arange(256, dtype=np.uint8)[::-1].copy()


@pytest.mark.parametrize("n", [1, 5 * W, 7 * W + 5])
def test_lane_layout_pack_matches_jax(n):
    """Kernel L's pack mode (its plain version): SEQ through the map, QUAL
    minus the bias and the reads' pos/reset equal _build_pack_pair's and
    _pos_reset_device's on the active rows."""
    rng = np.random.default_rng(n)
    dpad, soffs, qoffs, lengths = _block(rng, n)
    ll_mat, counts, S, _, _ = _seq_symbol_layout(lengths, W)
    Sp = pad_steps(max(S, 1))
    qbias = 33
    js, jq = (np.asarray(x) for x in PJ.pack_pair_device(
        jnp.asarray(dpad), soffs, qoffs, lengths, W, Sp, SEQ_MAP, qbias))
    Rpl = max(ll_mat.shape[0], 1)
    jll = np.zeros((Rpl, W), dtype=np.int32)
    jll[: ll_mat.shape[0]] = ll_mat
    jpos, jreset = (np.asarray(x) for x in SJ._pos_reset_device(
        jnp.asarray(jll), Sp, S, W))
    seq, qual, pos, reset = PT.lane_layout(
        torch.from_numpy(dpad), soffs, qoffs, lengths, ll_mat, W, Sp, S,
        SEQ_MAP, qbias)
    active = np.arange(Sp)[:, None] < counts[None, :]
    assert active.any() or n == 1
    for got, want in ((seq, js), (qual, jq), (pos, jpos), (reset, jreset)):
        assert got.shape == (Sp, W)
        assert np.array_equal(got.numpy().astype(np.int64)[active],
                              want.astype(np.int64)[active])
    # pos and reset are the whole matrix's, rows past a lane's total too
    assert np.array_equal(pos.numpy(), jpos.astype(np.int64))
    assert np.array_equal(reset.numpy(), jreset.astype(np.int64))


@pytest.mark.parametrize("n", [3, 6 * W + 1])
def test_step_inputs_match_jax(n):
    """Kernel L's step-input mode (its plain version): pos and reset equal
    _pos_reset_device's, rows past a lane's total included."""
    rng = np.random.default_rng(100 + n)
    lengths = _reads(rng, n, 40, zero=0.2)
    ll_mat, counts, S, _, _ = _seq_symbol_layout(lengths, W)
    Sp = pad_steps(S)
    jpos, jreset = (np.asarray(x) for x in SJ._pos_reset_device(
        jnp.asarray(ll_mat.astype(np.int32)), Sp, S, W))
    pos, reset = PT.step_inputs(ll_mat, Sp, S, W, "cpu")
    assert (counts < Sp).any()
    assert np.array_equal(pos.numpy(), jpos.astype(np.int64))
    assert np.array_equal(reset.numpy(), jreset.astype(np.int64))
    assert [t.dtype for t in (pos, reset)] == [torch.int32] * 2


@pytest.mark.parametrize("n", [2, 4 * W + 3])
def test_lane_unpack_matches_jax(n):
    """Kernel U (its plain version): the record-major SEQ through the map
    and QUAL plus the bias equal _build_unpack_pair's."""
    rng = np.random.default_rng(200 + n)
    lengths = _reads(rng, n, 31, zero=0.15)
    _, counts, S, _, _ = _seq_symbol_layout(lengths, W)
    Sp = pad_steps(S)
    seq = rng.integers(0, 4, size=(Sp, W)).astype(np.uint8)
    qual = rng.integers(0, 42, size=(Sp, W)).astype(np.uint8)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    js, jq = (np.asarray(x) for x in PJ.unpack_pair_device(
        jnp.asarray(seq), jnp.asarray(qual), starts, lengths, W, total,
        SEQ_MAP, 33))
    ts, tq = PT.unpack_pair(torch.from_numpy(seq), torch.from_numpy(qual),
                            starts, lengths, W, total, SEQ_MAP, 33)
    assert np.array_equal(ts[:total].numpy(), js[:total])
    assert np.array_equal(tq[:total].numpy(), jq[:total])


CFG = dict(lanes=64, aux_lanes=16, block_records=30)


def _from_fifo(tmp_path, data: bytes, encode) -> bytes:
    """encode(src, dst) with src a FIFO a writer thread fills in 97-byte
    writes; returns dst's bytes. Where encode fails before it opens the
    FIFO, opening the read end releases the writer."""
    fifo = tmp_path / "in.fifo"
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            for i in range(0, len(data), 97):
                f.write(data[i:i + 97])
    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    try:
        encode(str(fifo), str(tmp_path / "out.sfq"))
    finally:
        if writer.is_alive():
            os.close(os.open(fifo, os.O_RDONLY | os.O_NONBLOCK))
        writer.join(timeout=60)
    assert not writer.is_alive()
    return (tmp_path / "out.sfq").read_bytes()


@pytest.mark.parametrize("way", ["card", "mesh"])
def test_streaming_encode_from_a_pipe(tmp_path, way):
    """The streaming encode reads its input in order (1,500-byte chunks
    that cut records and blocks): from a FIFO, alone and sharded on a
    one-entry CPU mesh, it gives the whole-file container."""
    data = synth_fastq(70, read_len=30, seed=3, var_len=True, n_rate=0.005)
    whole = tapi.encode_fastq(data, device="cpu", level=3, **CFG)
    if way == "card":
        def encode(src, dst):
            tapi.encode_file_streaming(src, dst, level=3, device="cpu",
                                       chunk_bytes=1500, **CFG)
    else:
        mesh = tmesh.make_mesh(devices=["cpu"])

        def encode(src, dst):
            tsharded.encode_file_streaming_sharded(
                src, dst, level=3, mesh=mesh, chunk_bytes=1500, **CFG)
    assert _from_fifo(tmp_path, data, encode) == whole
