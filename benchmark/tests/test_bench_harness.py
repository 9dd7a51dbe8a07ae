"""The harness on the CPU: cells found by name, the window's arithmetic,
the trace reduction, the roofline byte counts, and the run's refusals."""

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import ROOT, make_copy

from sfqbench import loop, roofline, trace
from sfqbench.manifest import Cell
from sfqbench.record import Run


def test_a_new_cell_is_files_and_entries(tmp_path):
    bench = make_copy(str(tmp_path))
    cell = Cell("tiny", bench)
    assert cell.config["lanes"] == 64 and cell.traffic["reads"] == 300
    data = cell.generator().make_files(cell.traffic, 3)
    assert len(data) == 1 and data[0].count(b"\n") == 4 * 300
    names = [m["name"] for m, _ in cell.metrics(trace=True)]
    assert "prep.encode" in names and "compact_roofline" in names
    assert [m["name"] for m, _ in cell.metrics(trace=False)] == [
        "encode_GBps", "decode_GBps", "setup_s"]
    with pytest.raises(KeyError):
        Cell("no-such-cell", bench)
    # the configuration's stated cut is what the traffic sends
    path = os.path.join(bench, "configs", "tiny-l3.json")
    cfg = json.load(open(path))
    json.dump(dict(cfg, reads_per_file=301), open(path, "w"))
    with pytest.raises(ValueError):
        Cell("tiny", bench)


def test_every_cell_and_metric_has_its_files():
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        assert cell.generator().make_file
        for trace_on in (False, True):
            for _, mod in cell.metrics(trace_on):
                assert callable(mod.read)


def test_union_and_rates():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
    calls = [loop.Call("encode", 0, 10**9, 2.0),
             loop.Call("encode", 0, 10**9, 3.0),
             loop.Call("decode", 0, 10**9, 1.0),
             loop.Call("encode", 0, 10**9, float("nan"), error="boom")]
    assert loop.rate_GBps(calls, "encode") == pytest.approx(2 / 5)
    assert loop.rate_GBps(calls, "decode") == pytest.approx(1.0)
    assert loop.rate_GBps([], "decode") is None


def test_the_window_closes_at_the_first_call_past_its_length():
    def slow(x):
        time.sleep(0.04)
        return x
    calls = loop.closed_loop([b"ab"], slow, slow, 0.1)
    # ends at ~0.04, 0.08, 0.12: the third call ends past 0.1
    assert [c.kind for c in calls] == ["encode", "decode", "encode"]
    assert all(c.error is None and c.raw_bytes == 2 for c in calls)


def test_each_call_is_judged_as_it_ends_and_dropped(monkeypatch):
    from sfqbench.check import Judge
    files = [b"ab", b"cd"]
    judge = Judge(files)
    seen = []

    def after(c):
        seen.append((c.kind, c.out))
        judge(c)

    class Clock:  # each call takes one second; the check none
        now = 0.0

        def perf_counter(self):
            return self.now
    clock = Clock()
    outs = iter([b"E0", b"ab", b"E1", b"xx", b"E0", b"ab", b"E9", b"cd"])

    def code(x):
        clock.now += 1.0
        return next(outs)
    monkeypatch.setattr(loop, "time", clock)
    calls = loop.closed_loop(files, code, code, 7.5, after=after)
    assert [k for k, _ in seen] == ["encode", "decode"] * 4
    assert [o for _, o in seen] == [b"E0", b"ab", b"E1", b"xx", b"E0",
                                    b"ab", b"E9", b"cd"]
    assert all(c.out is None for c in calls)
    assert judge.held == {0: b"E0", 1: b"E1"}
    assert judge.decode_wrong == 1 and judge.encode_unstable == 1


class _Ev:
    """A kineto event as trace.reduce reads it."""

    def __init__(self, name, start, dur, device=False, mark=False,
                 thread=1, index=0, kind="kernel"):
        from torch.autograd import DeviceType
        self._v = (name, start, dur, DeviceType.CUDA if device
                   else DeviceType.CPU, mark, thread, index, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def device_index(self):
        return self._v[6]

    def activity_type(self):
        return self._v[7]


def test_trace_reduction():
    s = 10**9
    evs = [_Ev("bench.encode", 0, 10 * s, mark=True, kind="user_annotation"),
           _Ev("stage.wait_prep", 0, 4 * s, mark=True,
               kind="user_annotation"),
           _Ev("stage.prep", 0, 9 * s, mark=True, thread=2,
               kind="user_annotation"),
           _Ev("void lane_code_kernel<1>(int)", 4 * s, 2 * s, device=True),
           _Ev("rows_kernel", 5 * s, 2 * s, device=True),
           _Ev("sfq.encode.QUAL.coder", 4 * s, 5 * s, device=True,
               kind="gpu_user_annotation"),
           # the card's copies of the marks span only the card's work
           _Ev("bench.encode", 4 * s, 5 * s, device=True, mark=True,
               kind="gpu_user_annotation"),
           _Ev("stage.wait_prep", 4 * s, 3 * s, device=True, mark=True,
               kind="gpu_user_annotation"),
           _Ev("Memcpy HtoD (Pinned -> Device)", 8 * s, s, device=True,
               kind="gpu_memcpy")]
    got = trace.reduce(evs, "encode")
    assert got["busy_s"] == {0: pytest.approx(4.0)}  # [4, 7] and [8, 9]
    assert got["window_s"] == pytest.approx(10.0)
    assert got["kernels"] == {"lane_code_kernel": pytest.approx(2.0),
                              "rows_kernel": pytest.approx(2.0),
                              "Memcpy HtoD (Pinned -> Device)":
                              pytest.approx(1.0)}
    # idle: [0, 4] in the main thread's wait on prep, [7, 8] and [9, 10]
    # in no stage of the main thread (prep ran on another thread)
    assert got["gaps"] == {"encode.wait_prep": pytest.approx(4.0),
                           "encode.main": pytest.approx(2.0)}


PINNED = {"records": 65536, "bases": 6553600, "Rpl": 64, "W": 1024,
          "Sp": 6400}


def test_roofline_bytes_of_the_pinned_block():
    # chip_smoke.py's byte bounds of the pinned 65,536 x 100 bp block:
    # L pair mode 79.4 MB; L step-input mode 52.7 MB and U 26.7 MB
    assert roofline.lanes_pack(PINNED) == 79_429_888
    steps = 4 * 64 * 1024 + 8 * 6400 * 1024
    assert round(steps / 1e6, 1) == 52.7
    assert round((roofline.lanes_unpack(PINNED) - steps) / 1e6, 1) == 26.7
    assert roofline.peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak("cpu") is None


def test_no_device_number_from_a_cpu_run():
    call = loop.Call("encode", 0, 10, 1.0)
    call.trace = {"busy_s": {}, "window_s": 1.0, "kernels": {}, "gaps": {},
                  "stages": {"prep": 0.5}}
    run = Run([call], 1.0, "cpu", 1)
    assert run.idle_pct("encode") is None
    assert run.stage_ms_per_GB("encode", ["prep"]) == pytest.approx(5e10)
    run.shapes = {0: [PINNED]}
    assert roofline.share(run, "encode", ("lane_layout_kernel",),
                          roofline.lanes_pack) is None


def _run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, os.path.join(cwd, "benchmark",
                                                        "run.py"), *args],
                          capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_py(["--workload", "l3-illumina-bulk", "--seed", "1",
                 "--seconds", "1"], ROOT, env)
    assert r.returncode != 0 and "{" not in r.stdout


def test_without_the_program_no_result(tmp_path):
    make_copy(str(tmp_path))
    r = _run_py(["--workload", "tiny", "--seed", "1", "--seconds", "1"],
                str(tmp_path))
    assert r.returncode != 0 and "{" not in r.stdout


def test_a_cpu_rehearsal_loads_no_jax(tmp_path):
    bench = make_copy(str(tmp_path))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{bench!r}, {ROOT!r}]\n"
        "import importlib.util as u\n"
        f"s = u.spec_from_file_location('r', {bench + '/run.py'!r})\n"
        "run = u.module_from_spec(s); s.loader.exec_module(run)\n"
        "from sfqbench.manifest import Cell\n"
        f"cell = Cell('tiny', {bench!r})\n"
        "res = run.run_cell(cell, 5, 0.5, False, device='cpu',\n"
        "                   t0=time.perf_counter())\n"
        "print(json.dumps([res['checks'], run.forbidden_modules()]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    checks, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert bad == []
    assert all(c["value"] <= c["limit"] for c in checks.values())
