"""The metrics read from the program's own spans (sfqbench/spans.py and
their metric files): a traced CPU rehearsal of the tiny cell reads every
per-layer metric that a CPU run may read, the wrappers' metrics among
them; the readers' arithmetic (self time, pool sums, coverage, per GB,
per block) on a hand-made span log; and a program that keeps no log
gives every span metric None."""

import os
import time

import pytest
from conftest import load

from sfqbench import spans
from sfqbench.record import Run

from slimfastq_tpu_torch.utils import stats

SECONDS = 12.0  # an encode and a decode of the tiny file on the CPU

NEW = ("sfq.encode.index", "sfq.encode.prep", "sfq.encode.wait_prep",
       "sfq.encode.inputs", "sfq.encode.launch", "sfq.encode.wait_card",
       "sfq.encode.assemble", "unspanned.encode", "sfq.decode.launch",
       "sfq.decode.wait_card", "d2h_copies.decode", "sfq.decode.lanes",
       "sfq.decode.finish", "sfq.decode.wait_finish", "unspanned.decode")


def test_a_traced_rehearsal_reads_every_metric(tiny):
    bench, run, cell = tiny
    res = run.run_cell(cell, 2**31 + 7, SECONDS, True, device="cpu",
                       t0=time.perf_counter())
    assert res["correct"], res
    got = res["metrics"]
    per_layer = {m["name"]: m for m, _ in cell.metrics(trace=True)}
    assert set(NEW) <= set(per_layer)
    for name, m in per_layer.items():
        if m["source"] == "device_trace":  # no device number from a CPU
            assert name not in got, name
        else:  # the spans' and the wrappers' (their names still hold)
            assert got[name]["value"] >= 0, name
            assert got[name]["unit"] == m["unit"]
    assert len(per_layer) - len(NEW) == 13
    assert got["unspanned.encode"]["value"] < 10
    assert got["unspanned.decode"]["value"] < 10
    assert 5 <= got["d2h_copies.decode"]["value"] <= 7


def _span(name, i, parent, call, thread, start, end, **attrs):
    return stats.Span(name, i, parent, call, thread, start, end, attrs)


# one encode call (call 1, main thread 10, a pool thread 11) and one
# decode call (call 2), in ms; a span of no call (id 99) is left out
MS = 10**6
LOG = [
    _span("sfq.encode", 1, None, 1, 10, 0, 100 * MS,
          raw_bytes=2 * 10**9, blocks=4),
    _span("sfq.encode.index", 2, 1, 1, 10, 0, 10 * MS),
    _span("sfq.encode.step", 3, 1, 1, 10, 20 * MS, 90 * MS, blocks=4),
    _span("sfq.encode.inputs", 4, 3, 1, 10, 20 * MS, 40 * MS),
    _span("sfq.encode.lane_layout", 5, 4, 1, 10, 25 * MS, 35 * MS),
    _span("sfq.encode.QUAL.coder", 6, 3, 1, 10, 40 * MS, 60 * MS),
    _span("sfq.encode.compact", 7, 3, 1, 10, 60 * MS, 80 * MS),
    _span("sfq.encode.wait_card", 8, 7, 1, 10, 65 * MS, 80 * MS, bytes=8),
    _span("sfq.encode.prep", 9, None, 1, 11, 0, 50 * MS),
    _span("sfq.encode.prep", 10, None, 1, 11, 50 * MS, 70 * MS),
    _span("sfq.decode", 20, None, 2, 10, 200 * MS, 300 * MS,
          raw_bytes=10**9, blocks=2),
    _span("sfq.decode.step", 21, 20, 2, 10, 200 * MS, 280 * MS, blocks=2),
    _span("sfq.decode.lanes", 22, 21, 2, 10, 200 * MS, 250 * MS),
    _span("sfq.decode.wait_card", 23, 22, 2, 10, 210 * MS, 230 * MS),
    _span("sfq.decode.wait_card", 24, 21, 2, 10, 250 * MS, 255 * MS),
    _span("sfq.decode.wait_card", 25, 21, 2, 10, 255 * MS, 260 * MS),
    _span("sfq.decode.finish", 26, None, 2, 12, 250 * MS, 290 * MS),
    _span("sfq.test", 99, None, None, 10, 0, 10**12),
]


def test_readers_arithmetic_on_a_hand_made_log():
    s = spans.Spans(LOG)
    assert s.raw_GB("encode") == 2 and s.raw_GB("decode") == 1
    # self time: index 10; inputs 20 less its lane_layout 10, with it 20
    assert s.self_ms_per_GB("encode", ("sfq.encode.index",)) == 5
    assert s.self_ms_per_GB("encode", ("sfq.encode.inputs",)) == 5
    assert s.self_ms_per_GB("encode", ("sfq.encode.inputs",
                                       "sfq.encode.lane_layout")) == 10
    # the coder 20, compact 20 less its wait 15: launches 25 in 2 GB
    assert s.self_ms_per_GB("encode", ("sfq.encode.*.coder",
                                       "sfq.encode.compact")) == 12.5
    assert s.self_ms_per_GB("encode", ("sfq.encode.wait_card",)) == 7.5
    # the pool's spans on another thread: not main-thread time, summed
    assert s.self_ms_per_GB("encode", ("sfq.encode.prep",)) == 0
    assert s.pool_ms_per_GB("encode", "sfq.encode.prep") == 35
    assert s.pool_ms_per_GB("decode", "sfq.decode.finish") == 40
    # unspanned: the root's self (100 - 10 - 70 = 20) and the step's
    # (70 - 20 - 20 - 20 = 10) of the root's 100
    assert s.unspanned_pct("encode") == pytest.approx(30.0)
    # decode: root 100 - step 80 = 20; step 80 - 50 - 5 - 5 = 20
    assert s.unspanned_pct("decode") == pytest.approx(40.0)
    assert s.self_ms_per_GB("decode", ("sfq.decode.lanes",)) == 30
    assert s.self_ms_per_GB("decode", ("sfq.decode.wait_card",)) == 30
    assert s.per_block("decode", "sfq.decode.wait_card") == 1.5
    assert s.per_block("encode", "sfq.encode.wait_card") == 0.25


@pytest.mark.parametrize("name", NEW)
def test_each_reader_on_the_hand_made_log(monkeypatch, name):
    """Each metric file reads the log once taken for a run (and takes it
    once more for another run)."""
    from conftest import BENCH
    mod = load(os.path.join(BENCH, "metrics", name + ".py"),
               "span_metric_" + name.replace(".", "_"))
    taken = []
    monkeypatch.setattr(spans, "_take", lambda: taken.append(1) or LOG)
    a, b = Run([], 0.0, "cpu", 1), Run([], 0.0, "cpu", 1)
    va = mod.read(a)
    assert va is not None and va >= 0
    assert mod.read(a) == va and len(taken) == 1
    assert mod.read(b) == va and len(taken) == 2


def test_a_program_without_spans_reads_none(monkeypatch):
    """A program older than its span log (no stats.spans): every span
    metric reads None and nothing raises."""
    from conftest import BENCH
    monkeypatch.delattr(stats, "spans")
    run = Run([], 0.0, "cpu", 1)
    for name in NEW:
        mod = load(os.path.join(BENCH, "metrics", name + ".py"),
                   "span_metric_none_" + name.replace(".", "_"))
        assert mod.read(run) is None, name
