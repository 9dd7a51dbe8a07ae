"""What decides ``correct``, on the CPU at a size a test holds: a sound
run reads correct; each control (control.py) and each fault a cell can
have, planted under the timed path, reads not correct."""

import os
import time

import numpy as np
import pytest
from conftest import load

from sfqbench.manifest import Cell

SECONDS = 12.0  # longer than a tiny file's encode on the CPU (a few seconds)


def _run(tiny, **kw):
    bench, run, cell = tiny
    return run.run_cell(cell, 2**31 + 3, SECONDS, False, device="cpu",
                        t0=time.perf_counter(), **kw)


def test_a_sound_run_is_correct(tiny):
    res = _run(tiny)
    assert res["correct"], res
    assert res["_notes"]["lanes_compared"] > 0
    assert set(res["checks"]) == {"decode_wrong", "encode_unstable",
                                  "format_faults", "lanes_wrong"}


@pytest.mark.parametrize("control", ["lossy", "format"])
def test_each_control_fails(tiny, control):
    bench, _, cell = tiny
    ctl = load(os.path.join(bench, "control.py"), "bench_control_copy")
    got = ctl.run_control(cell, 17, control, device="cpu")
    assert not got["correct"], got
    sound = ctl.run_control(cell, 17, "none", device="cpu")
    assert sound["correct"], sound


def _half_batch(monkeypatch):
    from slimfastq_tpu_torch import api
    real = api.Card.encode
    monkeypatch.setattr(api.Card, "encode", lambda self, pres, cfg: real(
        self, pres[:max(1, len(pres) // 2)], cfg))


def _state_unchanged(monkeypatch):
    from slimfastq_tpu_torch import api
    monkeypatch.setattr(api, "decode_fastq_on",
                        lambda data, step, window: data)


def _token_altered(monkeypatch):
    from slimfastq_tpu_torch import api
    real = api.Card.encode

    def altered(self, pres, cfg):
        blocks = real(self, pres, cfg)
        pay = blocks[0].streams["QUAL"].payload
        pay[0, 0] = np.uint8(pay[0, 0] ^ 0x10)
        return blocks
    monkeypatch.setattr(api.Card, "encode", altered)


def _last_byte_altered(monkeypatch):
    """The last byte of lane 0's QUAL in every block: the flush's, which
    the round trip need not read, so only the reference's whole lanes
    see it."""
    from slimfastq_tpu_torch import api
    real = api.Card.encode

    def altered(self, pres, cfg):
        blocks = real(self, pres, cfg)
        for blk in blocks:
            st = blk.streams["QUAL"]
            end = int(st.lane_lens[0]) - 1
            st.payload[0, end] = np.uint8(st.payload[0, end] ^ 0x01)
        return blocks
    monkeypatch.setattr(api.Card, "encode", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered, _last_byte_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered", "last_byte_altered"])
def test_each_fault_fails(tiny, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny)
    assert not res["correct"], res
    if fault is _last_byte_altered:
        assert res["checks"]["lanes_wrong"]["value"] > 0, res


@pytest.mark.cuda
def test_controls_at_a_cells_size_on_the_card():
    """The controls of l3-illumina-bulk at its own size, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conftest import BENCH
    ctl = load(os.path.join(BENCH, "control.py"), "bench_control")
    cell = Cell("l3-illumina-bulk")
    for control in ("lossy", "format"):
        assert not ctl.run_control(cell, 29, control)["correct"]
