"""The port's spans (utils/stats) on the CPU at toy sizes: a round trip
under ``recording()`` gives the pipelines' span tree, one call id a
direction that the prep and finish pools' threads share, and spans that
cover the main thread's wall; with nothing recording a round trip keeps
nothing and enters no profiler range or NVTX range; the log's clock
agrees with the profiler's copies of the spans; the log's cap counts what
it drops; and the decode's copies to the host are one span each."""

import contextlib
import os
import statistics
import sys
import threading
from fnmatch import fnmatchcase

import pytest
import torch

from slimfastq_tpu_torch import api
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.utils import stats
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

CFG = dict(lanes=8, aux_lanes=4, block_records=16)

# each span name (fnmatch) -> the names its parent may have on its thread
# (None: the top of a thread); a pool's span opens at the top of its own
TREE = {
    "sfq.encode": {None},
    "sfq.encode.read": {"sfq.encode"},
    "sfq.encode.index": {"sfq.encode"},
    "sfq.encode.prep": {None},
    "sfq.encode.wait_prep": {"sfq.encode"},
    "sfq.encode.step": {"sfq.encode"},
    "sfq.encode.inputs": {"sfq.encode.step"},
    "sfq.encode.lane_layout": {"sfq.encode.inputs"},
    "sfq.encode.*.coder": {"sfq.encode.step"},
    "sfq.encode.wait_card": {"sfq.encode.step"},
    "sfq.encode.compact": {"sfq.encode.step"},
    "sfq.encode.assemble": {"sfq.encode.step"},
    "sfq.encode.wait_write": {"sfq.encode"},
    "sfq.encode.output": {"sfq.encode"},
    "sfq.decode": {None},
    "sfq.decode.wait_read": {"sfq.decode"},
    "sfq.decode.step": {"sfq.decode"},
    "sfq.decode.*.coder": {"sfq.decode.step"},
    "sfq.decode.lane_layout": {"sfq.decode.step"},
    "sfq.decode.unpack_pair": {"sfq.decode.step"},
    "sfq.decode.lanes": {"sfq.decode.step", "sfq.decode.lanes"},
    "sfq.decode.wait_card": {"sfq.decode.step", "sfq.decode.lanes"},
    "sfq.decode.finish": {None},
    "sfq.decode.wait_finish": {"sfq.decode"},
    "sfq.decode.write": {"sfq.decode"},
    "sfq.decode.output": {"sfq.decode"},
}
# the streaming forms' own (a chunk of the input read, a block written)
# and the in-memory forms' (the container's or the FASTQ's bytes made)
STREAMING = {"sfq.encode.read", "sfq.decode.write"}
IN_MEMORY = {"sfq.encode.output", "sfq.decode.output"}
POOL = ("sfq.encode.prep", "sfq.decode.finish")


def _pattern(name: str) -> str:
    found = [p for p in TREE if fnmatchcase(name, p)]
    assert found, f"span {name} is not in the tree"
    return found[0]


@pytest.fixture(scope="module")
def data():
    return synth_fastq(40, read_len=30, seed=2, var_len=True, n_rate=0.02)


def _fastq_round_trip(data, tmp):
    cfg = config_for_level(3, **CFG)
    enc = api.encode_fastq(data, cfg, device="cpu", window=2)
    assert api.decode_fastq(enc, device="cpu", window=2) == data
    return enc


def _file_round_trip(data, tmp):
    src, sfq, back = tmp / "a.fq", tmp / "a.sfq", tmp / "b.fq"
    src.write_bytes(data)
    api.encode_file_streaming(str(src), str(sfq), device="cpu", **CFG)
    api.decode_file_streaming(str(sfq), str(back), device="cpu")
    assert back.read_bytes() == data
    return sfq.read_bytes()


@pytest.fixture(scope="module", params=["fastq", "file"])
def recorded(request, data, tmp_path_factory):
    """(the spans of one recorded round trip, the container, the form)."""
    go = _fastq_round_trip if request.param == "fastq" else _file_round_trip
    stats.spans()
    with stats.recording():
        enc = go(data, tmp_path_factory.mktemp("spans"))
    log = stats.spans()
    assert log.dropped == 0
    return log.spans, enc, request.param


def _roots(spans):
    return {s.name: s for s in spans if s.parent is None
            and s.name in ("sfq.encode", "sfq.decode")}


def test_round_trip_gives_the_span_tree(recorded, data):
    spans, enc, form = recorded
    byid = {s.id: s for s in spans}
    roots = _roots(spans)
    assert set(roots) == {"sfq.encode", "sfq.decode"}
    assert roots["sfq.encode"].call != roots["sfq.decode"].call
    seen = set()
    for s in spans:
        pat = _pattern(s.name)
        seen.add(pat)
        parent = byid[s.parent].name if s.parent is not None else None
        assert parent in TREE[pat], (s.name, parent)
        if parent is not None:
            assert byid[s.parent].thread == s.thread
            p = byid[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        # every span of a direction carries its call's id, the pools'
        # spans on their own threads too
        root = roots["sfq." + s.name.split(".")[1]]
        assert s.call == root.call
        assert (s.thread != root.thread) == (s.name in POOL)
    assert seen == set(TREE) - (IN_MEMORY if form == "file" else STREAMING)
    # a direction's raw bytes and blocks on its root
    blocks = -(-len(data.splitlines()) // 4 // CFG["block_records"])
    for root in roots.values():
        assert root.attrs == {"raw_bytes": len(data), "blocks": blocks}
    assert sum(s.attrs["blocks"] for s in spans
               if s.name == "sfq.encode.step") == blocks
    preps = [s for s in spans if s.name == "sfq.encode.prep"]
    finishes = [s for s in spans if s.name == "sfq.decode.finish"]
    assert len(preps) == len(finishes) == blocks


def test_coder_spans_carry_their_slices(monkeypatch, data):
    """Each ``sfq.encode.<S>.coder`` span's ``slices`` counts the slices
    of its launch set of Kernel E: over an encode in slices of a few
    bit-steps they add up to the rows phase's runs."""
    from slimfastq_tpu_torch.ops import encode_torch as E
    runs = []
    rows_plain = E.rows_plain
    monkeypatch.setattr(E, "rows_plain",
                        lambda es, s0: runs.append(s0) or rows_plain(es, s0))
    monkeypatch.setattr(E, "SLICE_DECISIONS", 5 * CFG["lanes"])
    stats.spans()
    with stats.recording():
        api.encode_fastq(data, config_for_level(3, **CFG), device="cpu",
                         window=1)
    coders = [s for s in stats.spans().spans
              if fnmatchcase(s.name, "sfq.encode.*.coder")]
    slices = [s.attrs["slices"] for s in coders]
    assert len(coders) >= 7 and max(slices) > 1
    assert sum(slices) == len(runs)


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_spans_cover_the_main_thread(recorded, kind):
    """The spans but the root and the device steps cover at least 90% of
    the root's wall on its thread."""
    spans, _, _ = recorded
    root = _roots(spans)["sfq." + kind]
    bare = {root.id} | {s.id for s in spans if s.name == f"sfq.{kind}.step"}
    covered = sum(s.end_ns - s.start_ns for s in spans
                  if s.parent in bare and s.id not in bare)
    steps = sum(s.end_ns - s.start_ns for s in spans
                if s.name == f"sfq.{kind}.step")
    wall = root.end_ns - root.start_ns
    assert covered >= 0.9 * wall, (covered, steps, wall)


class _Counting:
    """record_function / NVTX stand-ins that count their uses."""

    def __init__(self):
        self.n = 0

    def record_function(self, name, *a, **k):
        self.n += 1
        return contextlib.nullcontext()

    def push(self, name):
        self.n += 1

    def pop(self):
        self.n += 1


@pytest.mark.parametrize("cuda_up", [False, True])
def test_off_keeps_nothing_and_enters_nothing(monkeypatch, data, tmp_path,
                                              cuda_up):
    counting = _Counting()
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting.record_function)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", counting.push)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", counting.pop)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_up)
    stats.spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    _fastq_round_trip(data, tmp_path)
    assert counting.n == 0
    assert stats.spans() == stats.Log([], 0)
    assert stats.current_call() is None


def test_log_clock_matches_the_profilers_copies():
    """Each span's start and end against its copy in a CPU profile of the
    same spans: the medians over 120 spans after the first are well
    under 200 us."""
    from torch.profiler import ProfilerActivity, profile
    stats.spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(121):
            with stats.trace(f"sfq.test.{i}"):
                sum(range(2000))
    log = {s.name: s for s in stats.spans().spans}
    copies = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("sfq.test.")}
    assert len(log) == len(copies) == 121
    starts, ends = [], []
    for i in range(1, 121):
        s, e = log[f"sfq.test.{i}"], copies[f"sfq.test.{i}"]
        starts.append(abs(s.start_ns - e.start_ns()))
        ends.append(abs(s.end_ns - (e.start_ns() + e.duration_ns())))
    assert statistics.median(starts) < 200_000, statistics.median(starts)
    assert statistics.median(ends) < 200_000, statistics.median(ends)


def test_the_log_counts_what_its_cap_drops(monkeypatch):
    monkeypatch.setattr(stats, "CAP", 5)
    stats.spans()
    with stats.recording():
        for i in range(8):
            with stats.trace("sfq.test", i=i):
                pass
    log = stats.spans()
    assert [s.attrs["i"] for s in log.spans] == list(range(5))
    assert log.dropped == 3
    assert stats.spans() == stats.Log([], 0)


def test_nesting_threads_calls_and_errors():
    """A span's parent is the enclosing span on its thread; a root opens
    a new call that its children and a pool's work handed its id share;
    a body's exception propagates and the span is still kept."""
    stats.spans()
    got = {}
    with stats.recording():
        with stats.root("sfq.encode", raw_bytes=3) as r:
            call = stats.current_call()
            with pytest.raises(KeyError):
                with stats.trace("sfq.encode.index"):
                    raise KeyError("body")
            t = threading.Thread(target=lambda: got.update(
                top=stats.current_call(),
                span=stats.trace("sfq.encode.prep", call=call)))
            t.start()
            t.join()
            with got["span"]:
                pass
            r.set(blocks=1)
        assert stats.current_call() is None
    spans = {s.name: s for s in stats.spans().spans}
    assert got["top"] is None
    root = spans["sfq.encode"]
    assert root.call == call and root.parent is None
    assert root.attrs == {"raw_bytes": 3, "blocks": 1}
    assert spans["sfq.encode.index"].parent == root.id
    assert spans["sfq.encode.index"].call == call
    assert spans["sfq.encode.prep"].call == call


def test_decode_copies_are_one_span_each(monkeypatch):
    """d2h_copies.decode's arithmetic on a 2-block file: the decode's
    ``sfq.decode.wait_card`` spans per block equal its copies to the host
    (every ``Tensor.cpu`` it reaches) per block, 7 at level 3 (LEN, FLAG,
    IDD, IDX, SEQX, SEQ, QUAL)."""
    data = synth_fastq(24, read_len=30, seed=5, var_len=True, n_rate=0.05)
    cfg = config_for_level(3, **CFG)
    enc = api.encode_fastq(data, cfg, device="cpu")
    copies = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **k):
        copies.append(self.shape)
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    stats.spans()
    with stats.recording():
        assert api.decode_fastq(enc, device="cpu") == data
    spans = stats.spans().spans
    waits = [s for s in spans if s.name == "sfq.decode.wait_card"]
    blocks = sum(s.attrs["blocks"] for s in spans
                 if s.name == "sfq.decode.step")
    assert blocks == 2
    assert len(waits) == len(copies) == 14
    assert len(waits) / blocks == 7
    assert sum(s.attrs["bytes"] for s in waits) == sum(
        int(torch.Size(sh).numel()) for sh in copies)
    assert {s.attrs["pinned"] for s in waits} == {0}


def test_off_spans_are_one_flag_test():
    """With nothing recording, trace and root hand back one shared
    do-nothing span."""
    assert not stats._recording
    a, b = stats.trace("sfq.x", k=1), stats.root("sfq.encode")
    assert a is b
    with a as sp:
        sp.set(blocks=2)
    assert stats.spans().spans == []


def test_threads_keep_every_span():
    """More threads than cores nest spans under a shortened switch
    interval: every span is kept once, under its own thread's parent."""
    n = min(32, 4 * (os.cpu_count() or 1))

    def work(k):
        for _ in range(200):
            with stats.trace("sfq.outer", k=k):
                with stats.trace("sfq.inner", k=k):
                    pass
    stats.spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with stats.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    log = stats.spans()
    assert log.dropped == 0 and len(log.spans) == 400 * n
    byid = {s.id: s for s in log.spans}
    assert len(byid) == len(log.spans)
    for s in log.spans:
        if s.name == "sfq.inner":
            p = byid[s.parent]
            assert (p.name, p.thread, p.attrs) == ("sfq.outer", s.thread,
                                                   s.attrs)
        else:
            assert s.parent is None and s.call is None
