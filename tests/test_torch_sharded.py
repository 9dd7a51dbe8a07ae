"""Block sharding of the port on a mesh of 8 CPU entries (the kernels'
plain versions; the JAX package's tests/test_parallel.py, ported): blocks
split over the shards, each shard on its own host thread, must give the
payloads and containers of the sequential path and of the JAX package's
8-device CPU mesh, byte for byte, and decode back (level 4:
tests/test_torch_sharded_l4.py)."""

import io

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.config import config_for_level as jconfig_for_level
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.parallel import mesh as jmesh
from slimfastq_tpu.parallel import sharded as jsharded
from slimfastq_tpu.pipeline import _scatter_record_symbols, _seq_symbol_layout
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import container as tcontainer
from slimfastq_tpu_torch import native
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import _cuda
from slimfastq_tpu_torch.parallel import mesh as tmesh
from slimfastq_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(1)

W, WA = 64, 16


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh.make_mesh(8)


def test_make_mesh_and_runs():
    """A mesh of CPU entries (one device named 8 times: 8 shards), the
    contiguous split of B blocks over it (runs that differ by at most one
    block, in mesh order, no padding) and the per-shard budget check; a
    CUDA entry without a card raises."""
    mesh = tmesh.make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and tmesh.shares(mesh, "cpu") == 8
    assert [len(r) for r in tmesh.runs(5, 8)] == [1] * 5 + [0] * 3
    assert [list(r) for r in tmesh.runs(7, 3)] == [[0, 1, 2], [3, 4], [5, 6]]
    assert sum(map(len, tmesh.runs(1000, 8))) == 1000
    assert tmesh.fits([5, 5, 5, 5], [10, 10]) and \
        not tmesh.fits([5, 6, 5, 5], [10, 10])
    assert tmesh.fits([50, 1], [10, 10])  # a shard's one block may pass
    with pytest.raises(ValueError, match="at least one"):
        tmesh.make_mesh(devices=[])
    with pytest.raises(ValueError, match="window"):
        tsharded.encode_fastq_sharded(
            b"", config_for_level(3), mesh=tmesh.make_mesh(devices=["cpu"]),
            window_blocks=tapi.MAX_WINDOW + 1)
    if not torch.cuda.is_available():
        for devices in (None, ["cpu", "cuda:0"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tmesh.make_mesh(devices=devices)


def test_launch_counts_from_shard_threads():
    """The launch counts are read-modify-writes shared by the shard
    threads: 16 threads, each counting 2,000 launches as its own shard,
    with the interpreter switching threads every microsecond, lose
    none."""
    import sys
    import threading
    _cuda.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            with _cuda.as_shard(i % 4):
                for _ in range(2000):
                    _cuda.count("lane_decode", 3, "cpu")
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert _cuda.launches["lane_decode"] == 32000
    assert _cuda.descs["lane_decode"] == 96000
    assert _cuda.by_shard == {(i, "cpu"): {"lane_decode": 8000}
                              for i in range(4)}
    _cuda.reset_launches()
    assert not _cuda.by_shard and not any(_cuda.launches.values())


def test_launch_counts_many_at_once_from_shard_threads():
    """count_many (Kernel E's launch set: one encode_run over its slices,
    each phase once a slice) adds every kernel's launches and descriptors
    in one update: 8 threads, each counting 1,000 launch sets of 5 slices
    of 3 blocks as its own shard, lose none."""
    import sys
    import threading
    _cuda.reset_launches()
    made = {"encode_run": (1, 5), "encode_rows": (5, 15),
            "encode_code": (5, 15)}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            with _cuda.as_shard(i % 2):
                for _ in range(1000):
                    _cuda.count_many(made, "cpu")
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for name, (k, n) in made.items():
        assert (_cuda.launches[name], _cuda.descs[name]) == (8000 * k,
                                                              8000 * n)
    assert _cuda.by_shard == {(i, "cpu"): {name: 4000 * k for name, (k, _)
                                           in made.items()}
                              for i in range(2)}
    assert _cuda.launches["lane_encode"] == 0
    _cuda.reset_launches()


def _qual_blocks(n_recs, seed):
    """Per block (syms, counts, pos, reset, steps) of a qual-like stream at
    W lanes, records of 10-59 symbols."""
    rng = np.random.default_rng(seed)
    out = []
    for n_rec in n_recs:
        lengths = rng.integers(10, 60, size=n_rec).astype(np.int64)
        _, counts, S, pos, reset = _seq_symbol_layout(lengths, W)
        recs = [np.clip(35 + np.cumsum(rng.integers(-2, 3, size=L)),
                        0, 63).astype(np.uint32) for L in lengths]
        out.append((_scatter_record_symbols(recs, W, S, counts), counts,
                    pos, reset, S))
    return [list(x) for x in zip(*out)]


def test_stream_blocks_match_jax_mesh(mesh8, jmesh8):
    """encode_stream_blocks and decode_stream_blocks over the 8-entry mesh
    (three blocks, whose pad_steps buckets differ: five shards idle) give
    the JAX package's sharded payloads and the symbols, block by
    block."""
    cfg = config_for_level(2, lanes=W, aux_lanes=WA)
    jcfg = jconfig_for_level(2, lanes=W, aux_lanes=WA)
    syms, counts, pos, reset, steps = _qual_blocks((64, 480, 16), 11)
    assert len({R.pad_steps(s.shape[0]) for s in syms}) > 1
    got = tmesh.encode_stream_blocks("qual", cfg.qual, mesh8, syms, counts,
                                     pos, reset)
    want = jmesh.encode_stream_blocks("qual", jcfg.qual, jmesh8, syms,
                                      counts, pos, reset)
    assert len(got) == 3
    for (p, lens), (pw, lw) in zip(got, want):
        assert np.array_equal(lens, lw)
        assert np.array_equal(p, np.asarray(pw))
    dec = tmesh.decode_stream_blocks("qual", cfg.qual, mesh8,
                                     [g[0] for g in got], [g[1] for g in got],
                                     counts, steps, pos, reset)
    for b, S in enumerate(steps):
        mask = np.arange(S)[:, None] < counts[b][None, :]
        assert np.array_equal(dec[b][mask], syms[b][:S][mask])


def test_seq_qual_raw_blocks_match_jax_mesh(mesh8, jmesh8):
    """SEQ and QUAL of three blocks from their raw bytes through the mesh
    (three shards of one block) against the JAX package's 8-device mesh,
    then decoded back to each block's record-major qualities."""
    from slimfastq_tpu_torch.pipeline import _lane_lengths_matrix
    from slimfastq_tpu_torch.pipeline_native import (
        _BASE_TO_CODE_DEV, _CODE_TO_BASE_FULL, prepare_block_fast)
    cfg = config_for_level(3, lanes=W, aux_lanes=WA, block_records=64)
    parts = [synth_fastq(64, read_len=30 + 5 * i, seed=i, var_len=True)
             for i in range(3)]
    pres = []
    for data in parts:
        idx, n = native.fastq_index(data)
        pres.append(prepare_block_fast(np.frombuffer(data, dtype=np.uint8),
                                       idx, 0, n, cfg))
    sgeoms = [p[0]["SEQ"][1] for p in pres]
    counts = [p[0]["SEQ"][3] for p in pres]
    qgeoms = [p[0]["QUAL"][1] for p in pres]
    minqs = [p[2] for p in pres]
    raws = [p[5] for p in pres]
    got = tmesh.encode_seq_qual_raw_blocks(sgeoms, mesh8, raws, counts,
                                           qgeoms, minqs, _BASE_TO_CODE_DEV)
    want = jmesh.encode_seq_qual_raw_blocks(sgeoms, jmesh8, raws, counts,
                                            qgeoms, minqs, _BASE_TO_CODE_DEV)
    for g, w in zip(got, want, strict=True):
        for name in ("SEQ", "QUAL"):
            assert np.array_equal(g[name][1], w[name][1])
            assert np.array_equal(g[name][0], np.asarray(w[name][0]))
    lens = [r[3] for r in raws]
    starts = [np.concatenate([[0], np.cumsum(L)[:-1]]).astype(np.int64)
              for L in lens]
    dec = tmesh.decode_seq_qual_raw_blocks(
        sgeoms, mesh8, [g["SEQ"][0] for g in got], [g["SEQ"][1] for g in got],
        [g["QUAL"][0] for g in got], [g["QUAL"][1] for g in got],
        [_lane_lengths_matrix(L, W) for L in lens], counts, starts, lens,
        [int(L.sum()) for L in lens], qgeoms, minqs, _CODE_TO_BASE_FULL)
    for (_, qual), data in zip(dec, parts):
        idx, n = native.fastq_index(data)
        buf = np.frombuffer(data, dtype=np.uint8)
        assert bytes(qual) == b"".join(bytes(buf[o: o + L]) for o, L in zip(
            idx["qual_off"], idx["seq_len"]))


def _three_ways(data, level, mesh8, jmesh8, **kw):
    """The port's sharded container on the 8-entry mesh, checked against
    the JAX package's sequential container and, given its mesh, its
    sharded one; decoded back on the mesh. Returns it."""
    cfg = config_for_level(level, **kw)
    jcfg = jconfig_for_level(level, **kw)
    enc = tsharded.encode_fastq_sharded(data, cfg, mesh=mesh8)
    assert enc == japi.encode_fastq(data, cfg=jcfg, backend=streams_jax)
    if jmesh8 is not None:
        assert enc == jsharded.encode_fastq_sharded(data, jcfg, mesh=jmesh8)
    assert tsharded.decode_fastq_sharded(enc, mesh=mesh8) == data
    return enc


def test_sharded_file_partial_last_block(mesh8, jmesh8):
    """Three blocks (64 x 2 + a ragged 20) over eight shards: the JAX
    package's containers, each block coded by its own shard thread."""
    data = synth_fastq(148, read_len=50, seed=21, var_len=True,
                       n_rate=0.01)
    _cuda.reset_launches()
    _three_ways(data, 2, mesh8, jmesh8, lanes=W, aux_lanes=WA,
                block_records=64)
    assert not _cuda.by_shard  # the CPU launches no kernel


def test_sharded_file_mixed_qual_depth_and_minq(mesh8, jmesh8):
    """Blocks with different qual depth (6 vs 7 bits) and minq, sharded:
    the per-block geometry goes with each block to its shard."""
    rng = np.random.default_rng(7)
    recs = []
    for r in range(128):
        L = int(rng.integers(20, 50))
        seq = bytes(rng.choice(list(b"ACGT"), size=L).astype(np.uint8))
        lo, span = (35, 40) if r < 64 else (33, 90)
        qual = bytes((lo + rng.integers(0, span, size=L)).astype(np.uint8))
        recs.append(b"@r%d\n%s\n+\n%s\n" % (r, seq, qual))
    data = b"".join(recs)
    enc = _three_ways(data, 2, mesh8, jmesh8, lanes=W, aux_lanes=WA,
                      block_records=64)
    f = io.BytesIO(enc)
    cfg = tcontainer.read_header(f)
    assert [b.qual_depth for b in tcontainer.iter_blocks(f, cfg)] == [6, 7]
