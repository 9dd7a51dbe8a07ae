"""The port's entry points (slimfastq_tpu_torch/entry.py) against the JAX
package's __graft_entry__.py on the CPU: entry()'s flagship step (Kernel
E's plain version on level-3 QUAL symbols) codes the same lanes byte for
byte, and dryrun_multichip over two CPU shards round-trips
its three phases, whose toy and level-4 containers equal the JAX
package's api.encode_fastq of the same data and config. Without a card
and without a CPU request, both raise."""

import hashlib

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from slimfastq_tpu import api as japi
from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import entry

torch.set_num_threads(1)

# SHA-256 of the JAX package's container of the match phase's input,
# corpus("novaseq", 3072, seed=3) at config_for_level(4, lanes=64,
# aux_lanes=16, block_records=1536) (its api.encode_fastq on a CPU;
# tests/test_torch_entry_pin.py recomputes it)
MATCH_SHA256 = ("3db7737de401b52cf2524b43e47b5a0f"
                "38992a16debe8b85c58c3a6b73f928d3")
MATCH_BYTES = 108372


def test_entry_equals_jax_entry():
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    ebufs, eptrs, low, emax = fn(*args)
    jfn, jargs = jentry.entry()
    jb, jp, jlow, jmax = (np.asarray(x) for x in jfn(*jargs))
    NC, W = jp.shape
    assert ebufs.shape == (NC, W, jb.shape[1] // W)
    assert np.array_equal(ebufs.numpy(), jb.reshape(ebufs.shape))
    assert np.array_equal(eptrs.numpy(), jp)
    assert np.array_equal(low.numpy().view(np.uint32), jlow)
    assert int(emax) == int(jmax)


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_entry_points_need_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "entry":
            entry.entry()
        else:
            entry.dryrun_multichip(1)


@pytest.fixture(scope="module")
def dryrun():
    return entry.dryrun_multichip(2, devices=["cpu"] * 2)


def test_dryrun_runs_three_phases(dryrun):
    assert list(dryrun) == ["toy", "production", "match"]
    assert all(isinstance(v, bytes) and v for v in dryrun.values())


def test_dryrun_toy_equals_jax(dryrun):
    data = synth_fastq(32 * 2 + 12, read_len=20, seed=0, var_len=True,
                       n_rate=0.01)
    cfg = config_for_level(2, lanes=16, aux_lanes=8, block_records=32)
    assert dryrun["toy"] == japi.encode_fastq(data, cfg,
                                              backend=streams_jax)


def test_dryrun_match_equals_jax(dryrun):
    enc = dryrun["match"]
    assert len(enc) == MATCH_BYTES
    assert hashlib.sha256(enc).hexdigest() == MATCH_SHA256


def test_dryrun_wrong_mesh_size():
    with pytest.raises(RuntimeError, match="need 3 devices, have 2"):
        entry.dryrun_multichip(3, devices=["cpu"] * 2)
