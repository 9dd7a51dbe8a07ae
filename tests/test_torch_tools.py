"""The port's measurement tools on the CPU at toy sizes:
tools/bench_1gb_torch.py's streaming run (the CLI's streaming encode and
decode as watched children, a file of several read chunks) and the
streaming encode's chunk walker (each block a range of its own),
tools/profile_wall_torch.py's stage wrapping (the container does not
move), tools/longread_l4_torch.py's arena reckoning against a count made
read by read with the matcher's own sampling rule; the three pipeline
variables the port reads as the JAX package does (SFQ_PIPE_DEPTH,
SFQ_BATCH_BLOCKS, SFQ_PIPE_OMP_THREADS): the same bytes under each, and
each takes effect; and each tool exits 1 with ``no CUDA device`` when
there is no card and no CPU request."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slimfastq_tpu_torch import api, native
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.models import matcher as M
from slimfastq_tpu_torch.utils.synth import synth_fastq
from tools import bench_1gb_torch as B
from tools import longread_l4_torch as L
from tools import profile_wall_torch as P

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=8, aux_lanes=4, block_records=16)


@pytest.fixture(scope="module")
def data():
    return synth_fastq(32, read_len=30, seed=2, var_len=True, n_rate=0.02)


@pytest.fixture(scope="module")
def plain(data):
    return api.encode_fastq(data, config_for_level(3, **CFG), device="cpu")


def test_streaming_scale_several_chunks(tmp_path):
    out = B.streaming_scale([6000, 14000], str(tmp_path), device="cpu",
                            piece_reads=30, chunk_bytes=2500)
    assert out["base_rss_bytes"] > 0
    small, large = out["sizes"]
    assert small["raw_bytes"] >= 6000 and large["raw_bytes"] >= 14000
    assert large["chunks"] >= 5
    for row in out["sizes"]:
        assert row["round_trip_exact"]
        assert row["encode_peak_rss_bytes"] > 0
        assert row["decode_peak_rss_bytes"] > 0
        assert row["encode_wall_s"] > 0 and row["ratio"] > 1
    assert out["rss_bound"]["holds"]


def test_profile_keeps_the_container(data, plain):
    cfg = config_for_level(3, **CFG)
    enc, rep = P.profile_cell(data, cfg, "cpu", 1)
    assert enc == plain
    assert rep["windows"] == 1 and rep["blocks"] == 2
    enc_stages = rep["encode"]["per_window_min_s"]
    for stage in ("prep", "device_step", "wait_prep", "write_block",
                  "flush_append", "fastq_index"):
        assert stage in enc_stages
    for stage in ("device_step", "finish", "fastq_assemble", "read_block"):
        assert stage in rep["decode"]["per_window_min_s"]
    # every wrapped attribute is restored
    assert api.Card.encode.__qualname__ == "Card.encode"
    assert api.ThreadPoolExecutor.__module__ == "concurrent.futures.thread"
    assert api.encode_fastq(data, cfg, device="cpu") == plain


@pytest.mark.parametrize("var", ["SFQ_PIPE_DEPTH", "SFQ_BATCH_BLOCKS",
                                 "SFQ_PIPE_OMP_THREADS"])
def test_pipeline_variable(monkeypatch, data, plain, var):
    """With the variable at 1: the same bytes both ways, and the prep
    pool one worker wide (SFQ_PIPE_DEPTH), one window a block
    (SFQ_BATCH_BLOCKS), or OpenMP teams of one on the pipeline's main
    thread, which the cap sets (SFQ_PIPE_OMP_THREADS; an OpenMP thread
    count is the calling thread's, as in the JAX package)."""
    cfg = config_for_level(3, **CFG)
    seen = {"widths": [], "windows": [], "omp": []}
    pool, card_encode = api.ThreadPoolExecutor, api.Card.encode

    class Pool(pool):
        def __init__(self, max_workers=None, **kw):
            seen["widths"].append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    def encode(self, pres, cfg):
        seen["windows"].append(len(pres))
        seen["omp"].append(int(native.lib.get_omp_threads()))
        return card_encode(self, pres, cfg)

    monkeypatch.setattr(api, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(api.Card, "encode", encode)
    monkeypatch.setenv(var, "1")
    enc = api.encode_fastq(data, cfg, device="cpu")
    assert enc == plain
    assert api.decode_fastq(enc, device="cpu") == data
    if var == "SFQ_PIPE_DEPTH":
        assert seen["widths"][:2] == [1, 1]  # the prep pool, the writer
    elif var == "SFQ_BATCH_BLOCKS":
        assert seen["windows"] == [1, 1]
    else:
        assert seen["omp"] == [1]
    # unset, the defaults: a window of the 2 blocks, a prep pool of 2,
    # teams of half the cores
    monkeypatch.delenv(var)
    for v in seen.values():
        v.clear()
    assert api.encode_fastq(data, cfg, device="cpu") == plain
    assert seen["widths"][0] == 2 and seen["windows"] == [2]
    assert seen["omp"] == [max(1, (os.cpu_count() or 4) // 2)]


def test_omp_cap_zero_leaves_teams(monkeypatch):
    before = int(native.lib.get_omp_threads())
    monkeypatch.setenv("SFQ_PIPE_OMP_THREADS", "0")
    with native.pipeline_omp_cap():
        assert int(native.lib.get_omp_threads()) == before
    assert int(native.lib.get_omp_threads()) == before


def test_arena_cursor_counts_sampled_keys():
    """The vectorised reckoning against a dict filled read by read with
    the matcher's own K-mers and sampling rule (models/matcher.py)."""
    data = synth_fastq(300, read_len=120, seed=5, var_len=True,
                       n_rate=0.01)
    counts = {}
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    for r in range(n):
        o, ln = int(idx["seq_off"][r]), int(idx["seq_len"][r])
        km = M._kmers(M._B2C0[buf[o:o + ln]])
        for p in M._sampled(km):
            counts[int(km[p])] = counts.get(int(km[p]), 0) + 1
    grown = sum(c >= L.GROW_AT for c in counts.values())
    got = L.arena_cursor(data, chunk=64)
    assert got["sampled"] == sum(counts.values())
    assert got["distinct_keys"] == len(counts)
    assert got["keys_reaching_5"] == grown > 0
    assert got["cursor"] == 4 * len(counts) + 16 * grown
    assert not got["passes_blk_limit"]


@pytest.mark.parametrize("tool", ["bench_1gb_torch.py",
                                  "profile_wall_torch.py",
                                  "longread_l4_torch.py",
                                  "decode_streams.py",
                                  "block_spans.py",
                                  "matcher_overflow_torch.py"])
def test_tool_needs_a_card(tool):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", tool)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr
    assert not r.stdout


@pytest.mark.parametrize("cuda_up", [False, True])
def test_trace_nvtx_range(monkeypatch, cuda_up):
    """While spans are recorded, utils/stats.trace pushes an NVTX range of
    its name once CUDA is initialised (none before), pops it on the way
    out, and lets the body's exception through (the span is kept)."""
    from slimfastq_tpu_torch.utils import stats
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_up)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    stats.spans()
    with stats.recording():
        with pytest.raises(KeyError):
            with stats.trace("sfq.test"):
                raise KeyError("body")
    assert calls == ([("push", "sfq.test"), ("pop",)] if cuda_up else [])
    assert [s.name for s in stats.spans().spans] == ["sfq.test"]


def test_streaming_ranges_own_their_blocks(tmp_path):
    """The streaming encode's chunk walker yields each block as a range of
    its own (a copy of its bytes, its index rebased to them), so a block
    prepared ahead holds no chunk: the blocks are the file's records in
    order, 8 a block, also where a chunk holds less than a block (it is
    read again longer)."""
    data = synth_fastq(50, read_len=30, seed=3, var_len=True, n_rate=0.02)
    src = tmp_path / "a.fq"
    src.write_bytes(data)
    cfg = config_for_level(3, block_records=8)
    blocks = []
    for buf, idx, lo, hi in api.iter_block_ranges_native(str(src), cfg,
                                                         chunk_bytes=700):
        assert buf.base is None and lo == 0 and hi == len(idx["seq_len"])
        assert int(idx["id_off"][0]) == 1
        blocks.append(bytes(buf))
    assert len(blocks) == 7
    assert b"\n".join(blocks) + b"\n" == data
