"""The port's small-block window path on the CPU (the kernels' plain
versions): api.encode_fastq / decode_fastq code a window of blocks with one
launch per stream, and the container must equal the one-block-at-a-time
container and the JAX package's (whose own window path is its
streams_jax.*_blocks, jit(vmap) over blocks), byte for byte. Also the
batched surface (streams_torch.*_blocks, parallel.mesh with mesh=None)
against the JAX package's parallel/mesh.py on ragged windows, and the
batched plain versions of Kernels E, D and C against the one-block ones."""

import io

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.parallel import mesh as jmesh
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import compact_torch as CC
from slimfastq_tpu_torch.ops import streams_torch as ST
from slimfastq_tpu_torch.parallel import mesh as tmesh
from slimfastq_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(1)

CFG = dict(lanes=64, aux_lanes=16, block_records=30)


def _fastq(seqs) -> bytes:
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                    for i, s in enumerate(seqs))


@pytest.fixture(scope="module")
def data():
    """Three blocks in one window: reads of varied lengths with N bases,
    then a block of empty reads (no SEQ, QUAL or SEQX step), then a short
    last block (10 records)."""
    return (synth_fastq(30, read_len=30, seed=11, var_len=True,
                        n_rate=0.01) + _fastq([b""] * 30) +
            synth_fastq(10, read_len=30, seed=12, var_len=True,
                        n_rate=0.01))


@pytest.fixture(scope="module")
def jax_l2(data):
    return japi.encode_fastq(data, level=2, backend=streams_jax, **CFG)


def test_window_encode_equals_reference_l2(data, jax_l2):
    assert tapi._batch_window(config_for_level(2, **CFG)) == 8
    assert tapi.encode_fastq(data, device="cpu", level=2, **CFG) == jax_l2


def test_window_encode_equals_reference_l3(data):
    """Equal to window=1 and to the JAX package's container; decodes."""
    bat = tapi.encode_fastq(data, device="cpu", level=3, **CFG)
    assert bat == tapi.encode_fastq(data, device="cpu", level=3,
                                    window=1, **CFG)
    assert bat == japi.encode_fastq(data, level=3, backend=streams_jax,
                                    **CFG)
    assert tapi.decode_fastq(bat, device="cpu") == data


def test_window_decode_of_reference_container(data, jax_l2):
    """The JAX package's container decoded in a window equals it decoded
    one block at a time and the input."""
    assert tapi.decode_fastq(jax_l2, device="cpu") == data
    assert tapi.decode_fastq(jax_l2, device="cpu", window=1) == data


def test_window_default():
    """Up to 8 blocks and 262,144 records a window (the H100 sweep)."""
    assert [tapi._batch_window(config_for_level(3, block_records=br))
            for br in (40, 16384, 65536, 131072, 262144, 1 << 20)] == \
        [8, 8, 4, 2, 1, 1]
    assert tapi._batch_window(config_for_level(3), 16) == 16


def test_window_refused_past_its_cap():
    with pytest.raises(ValueError, match="window"):
        tapi.encode_fastq(b"", device="cpu", window=tapi.MAX_WINDOW + 1)


# ---------------------------------------------------------------------------
# the batched surface against the JAX package's parallel/mesh.py
# ---------------------------------------------------------------------------

def _ragged_window(rng, kind, W, steps):
    syms, counts = [], []
    for S in steps:
        c = rng.integers(0, S + 1, size=W)
        c[-1] = S
        hi = 256 if kind == "byte" else 2
        syms.append(rng.integers(0, hi, size=(S, W)).astype(np.uint32))
        counts.append(c.astype(np.int64))
    return syms, counts


@pytest.mark.parametrize("kind", ["byte", "flag"])
def test_stream_blocks_match_jax_mesh(kind):
    """encode/decode_stream_blocks over a ragged window (12, 40, 0 and 5
    steps; an empty block) through parallel.mesh with mesh=None against
    the JAX package's mesh-free vmapped kernels, block by block."""
    cfg = config_for_level(3, lanes=16, aux_lanes=8)
    geom = cfg.bytes_ if kind == "byte" else cfg.flags
    rng = np.random.default_rng(7)
    steps = [12, 40, 0, 5]
    syms, counts = _ragged_window(rng, kind, 8, steps)
    got = tmesh.encode_stream_blocks(kind, geom, None, syms, counts,
                                     device="cpu")
    nonempty = [b for b, S in enumerate(steps) if S]
    want = jmesh.encode_stream_blocks(kind, geom, None,
                                      [syms[b] for b in nonempty],
                                      [counts[b] for b in nonempty])
    for b, (p, lens) in zip(nonempty, want):
        assert np.array_equal(got[b][1], lens)
        assert np.array_equal(got[b][0], np.asarray(p))
    assert got[2][0].shape == (8, 0) and not got[2][1].any()
    dec = tmesh.decode_stream_blocks(kind, geom, None, [g[0] for g in got],
                                     [g[1] for g in got], counts, steps,
                                     device="cpu")
    for b, S in enumerate(steps):
        mask = np.arange(S)[:, None] < counts[b][None, :]
        assert dec[b].shape == (S, 8)
        assert np.array_equal(dec[b][mask], syms[b][mask])


def test_mesh_refused():
    """A mesh of CPU entries (three shards, one device named three times)
    gives what mesh=None gives: the stream blocks of a ragged window and
    a window of container blocks' FASTQ parts, in order. What is refused
    is a CUDA mesh entry without a card: it raises, and never runs on the
    CPU instead."""
    from slimfastq_tpu_torch import api as tapi
    cfg = config_for_level(3, lanes=16, aux_lanes=8, block_records=10)
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3
    syms, counts = _ragged_window(np.random.default_rng(7), "byte", 8,
                                  [12, 40, 0, 5])
    got = tmesh.encode_stream_blocks("byte", cfg.bytes_, mesh, syms, counts)
    want = tmesh.encode_stream_blocks("byte", cfg.bytes_, None, syms, counts,
                                      device="cpu")
    for (p, lens), (pw, lw) in zip(got, want, strict=True):
        assert np.array_equal(p, pw) and np.array_equal(lens, lw)
    data = synth_fastq(35, read_len=20, seed=4, var_len=True)
    enc = tapi.encode_fastq(data, cfg=cfg, device="cpu")
    from slimfastq_tpu_torch import container
    f = io.BytesIO(enc)
    blocks = list(container.iter_blocks(f, container.read_header(f)))
    assert len(blocks) == 4
    parts = tsharded.decode_blocks_sharded(blocks, cfg, mesh)
    assert [bytes(p) for p in parts] == [
        bytes(p) for p in tsharded.decode_blocks_sharded(blocks, cfg, None,
                                                         "cpu")]
    assert b"".join(bytes(p) for p in parts) == data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(devices=["cuda:0"])


def test_seq_qual_raw_blocks_match_jax_mesh():
    """SEQ and QUAL of three blocks of different read counts and lengths
    (one without bases) from raw bytes, encoded through parallel.mesh
    (mesh=None) against the JAX package's, then decoded back to the
    record-major bytes."""
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.pipeline import _lane_lengths_matrix
    from slimfastq_tpu_torch.pipeline_native import (
        _BASE_TO_CODE_DEV, _CODE_TO_BASE_FULL, prepare_block_fast)
    cfg = config_for_level(3, lanes=16, aux_lanes=8, block_records=64)
    parts = [synth_fastq(50, read_len=30, seed=1, var_len=True),
             _fastq([b""] * 3),
             synth_fastq(64, read_len=45, seed=2, var_len=True)]
    pres = []
    for data in parts:
        idx, n = native.fastq_index(data)
        pres.append(prepare_block_fast(np.frombuffer(data, dtype=np.uint8),
                                       idx, 0, n, cfg))
    args = ([p[0]["SEQ"][1] for p in pres], None, [p[5] for p in pres],
            [p[0]["SEQ"][3] for p in pres], [p[0]["QUAL"][1] for p in pres],
            [p[2] for p in pres], _BASE_TO_CODE_DEV)
    got = tmesh.encode_seq_qual_raw_blocks(*args, device="cpu")
    want = jmesh.encode_seq_qual_raw_blocks(*args)
    for g, w, pre in zip(got, want, pres):
        for name in ("SEQ", "QUAL"):
            assert np.array_equal(g[name][1], w[name][1])
            assert np.array_equal(g[name][0], np.asarray(w[name][0]))
    lens = [p[5][3] for p in pres]
    starts = [np.concatenate([[0], np.cumsum(L)[:-1]]).astype(np.int64)
              for L in lens]
    dec = tmesh.decode_seq_qual_raw_blocks(
        args[0], None, [g["SEQ"][0] for g in got], [g["SEQ"][1] for g in got],
        [g["QUAL"][0] for g in got], [g["QUAL"][1] for g in got],
        [_lane_lengths_matrix(L, 16) for L in lens], args[3], starts, lens,
        [int(L.sum()) for L in lens], args[4], args[5], _CODE_TO_BASE_FULL,
        device="cpu")
    for (seq, qual), data, pre in zip(dec, parts, pres):
        idx, n = native.fastq_index(data)
        buf = np.frombuffer(data, dtype=np.uint8)
        want_q = b"".join(bytes(buf[o: o + L]) for o, L in zip(
            idx["qual_off"], idx["seq_len"]))
        assert bytes(qual) == want_q
        assert len(seq) == len(want_q)


# ---------------------------------------------------------------------------
# the batched plain versions of Kernels E, D and C
# ---------------------------------------------------------------------------

def test_batched_plain_versions_equal_single():
    """lane_encode_blocks / lane_decode_blocks (and their _plain forms)
    over a ragged window (NC, Sp and Lb differ per block) equal the
    one-block plain versions block by block (E's online schedule equal to
    the closed form's); Kernel C's window form equals
    compact_streams_plain on each block's stream."""
    cfg = config_for_level(3, lanes=16, aux_lanes=8)
    geom = cfg.bytes_
    rng = np.random.default_rng(3)
    items, streams = [], []
    for S in (16, 40, 8):
        syms = torch.from_numpy(rng.integers(0, 256, size=(S, 8)).astype(
            np.uint8))
        counts = rng.integers(1, S + 1, size=8)
        items.append(CT.EncIn(syms, None, None,
                              torch.from_numpy(counts.astype(np.int32))))
        streams.append((syms.int(), counts))
    CB = ST._chunk_bytes(geom.depth, False)
    enc = CT.lane_encode_blocks(items, "byte", geom, CB)
    assert [e[0].shape[0] for e in enc] == [2, 5, 1]
    for e, p, it in zip(enc, CT.lane_encode_blocks_plain(items, "byte", geom,
                                                         CB), items):
        z = torch.zeros(it.syms.shape, dtype=torch.int32)
        i, b = ST._schedule("byte", geom, it.syms, z, z, it.counts)
        assert all(torch.equal(x, y) for x, y in zip(
            (i, b), CT.online_schedule("byte", geom, it)))
        for x, y, z in zip(e, p, CT.lane_encode_plain(i, b, geom, CB)):
            assert torch.equal(x, y) and torch.equal(x, z)
    comp = [(e[0], e[1], max(int(e[1].sum(dim=0).max()), 1)) for e in enc]
    flat, layout = CC.compact_streams_dev(comp, [e[2] for e in enc])
    for (pay, tot, tail), c, e in zip(layout.views(flat), comp, enc):
        f1, l1 = CC.compact_streams_plain([c], [e[2]])
        p1, t1, tl1 = l1.views(f1)[0]
        assert torch.equal(pay, p1) and torch.equal(tot, t1)
        assert torch.equal(tail, tl1)
    items = []
    for (pay, tot, _), e, (syms, counts) in zip(layout.views(flat), enc,
                                                 streams):
        p, lens = ST._flush_append(pay.numpy(), tot.numpy().astype(np.int64),
                                   e[2].numpy().view(np.uint32), counts)
        Sp = syms.shape[0]
        z = torch.zeros((Sp, 8), dtype=torch.int32)
        items.append((torch.from_numpy(p), torch.from_numpy(
            lens.astype(np.int32)), torch.from_numpy(counts.astype(
                np.int32)), z, z))
    assert len({it[0].shape[1] for it in items}) == 3  # Lb differs
    dec = CT.lane_decode_blocks(items, "byte", geom)
    for d, p, it, (syms, counts) in zip(
            dec, CT.lane_decode_blocks_plain(items, "byte", geom), items,
            streams):
        assert torch.equal(d, p)
        assert torch.equal(d, CT.lane_decode_plain(*it, "byte", geom))
        mask = torch.arange(syms.shape[0])[:, None] < torch.from_numpy(
            counts)[None, :]
        assert torch.equal(d[mask].int(), syms[mask])


def test_window_launch_refusals():
    geom = config_for_level(3).bytes_
    z = CT.EncIn(torch.zeros((8, 8), dtype=torch.uint8), None, None,
                 torch.zeros(8, dtype=torch.int32))
    z4 = CT.EncIn(z.syms[:, :4], None, None, z.counts[:4])
    with pytest.raises(ValueError, match="blocks"):
        CT.lane_encode_blocks([], "byte", geom, 16)
    with pytest.raises(ValueError, match="same lanes"):
        CT.lane_encode_blocks([z, z4], "byte", geom, 16)
    pay = torch.zeros((8, 4), dtype=torch.uint8)
    lens = torch.zeros(8, dtype=torch.int32)
    a = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="every block"):
        CT.lane_decode_blocks([(pay, lens, lens, a, a, a.to(torch.uint8)),
                               (pay, lens, lens, a, a, None)], "seq",
                              config_for_level(4).seq)


def test_sharded_forms_without_mesh():
    """parallel.sharded with mesh=None: a window of prepared blocks encodes
    to the blocks each coded alone, in order, and the window of container
    blocks decodes to their FASTQ parts, in order."""
    from slimfastq_tpu_torch import container, native
    from slimfastq_tpu_torch.pipeline_native import (encode_prepared_block,
                                                     prepare_block_fast)
    cfg = config_for_level(3, lanes=16, aux_lanes=8, block_records=20)
    data = synth_fastq(35, read_len=20, seed=4, var_len=True)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    pres = [prepare_block_fast(buf, idx, lo, min(lo + 20, n), cfg)
            for lo in (0, 20)]
    blks = tsharded.encode_prepared_blocks_sharded(pres, cfg, None, "cpu")
    for blk, pre in zip(blks, pres):
        alone = encode_prepared_block(pre, cfg, "cpu")
        for name, es in alone.streams.items():
            assert np.array_equal(blk.streams[name].payload, es.payload)
            assert np.array_equal(blk.streams[name].lane_lens, es.lane_lens)
    out = io.BytesIO()
    for blk in blks:
        container.write_block(out, blk)
    out.seek(0)
    back = [container.read_block(out) for _ in blks]
    parts = tsharded.decode_blocks_sharded(back, cfg, None, "cpu")
    assert b"".join(bytes(p) for p in parts) == data
