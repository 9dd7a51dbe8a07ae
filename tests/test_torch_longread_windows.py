"""The long-read path's window rules on the CPU (the kernels' plain
versions), against the JAX package's container of three small blocks: a
lowered device-byte budget splits encode and decode windows (and a
lowered prep-ahead) without changing a byte, and an optimistic chunk
buffer overflowed on the host-pack path reruns its streams with hard
buffers and keeps the bytes."""

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import pipeline_native as TPN
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import streams_torch as ST
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

KW = dict(lanes=128, aux_lanes=16, block_records=70)


@pytest.fixture(scope="module")
def three_blocks():
    """Three blocks of 70 records, the JAX package's container, and the
    port's with the default budget (one window of three)."""
    data = synth_fastq(200, read_len=40, seed=12, var_len=True,
                       n_rate=0.005)
    enc_j = japi.encode_fastq(data, level=3, backend=streams_jax, **KW)
    return data, enc_j, tapi.encode_fastq(data, device="cpu", level=3, **KW)


def _count_calls(monkeypatch, mod, name):
    sizes, fn = [], getattr(mod, name)

    def counted(*args, **kw):
        sizes.append(len(args[0]))
        return fn(*args, **kw)
    monkeypatch.setattr(mod, name, counted)
    return sizes


def test_window_budget_splits_encode(three_blocks, monkeypatch):
    """With the default budget the three blocks code in one window; with
    the CPU budget lowered below one block's SEQ/QUAL bytes (and the
    prep-ahead bytes below one block's raw bytes) each codes alone, and
    every container equals the JAX package's: the bytes do not depend on
    the window."""
    data, enc_j, enc_t = three_blocks
    assert enc_t == enc_j
    sizes = _count_calls(monkeypatch, tapi, "encode_prepared_blocks")
    assert tapi.encode_fastq(data, device="cpu", level=3, **KW) == enc_j
    assert sizes == [3]
    sizes.clear()
    monkeypatch.setattr(ST, "CPU_BUDGET", 1)
    monkeypatch.setattr(tapi, "_PREP_BYTES", 1)
    assert tapi.encode_fastq(data, device="cpu", level=3, **KW) == enc_j
    assert sizes == [1, 1, 1]


def test_window_budget_splits_decode(three_blocks, monkeypatch):
    """decode_blocks_device splits a window's SEQ/QUAL launches into runs
    within the budget once LEN gives each block's lengths: one run of
    three by default, three of one with the budget lowered; the decode is
    exact either way."""
    data, enc_j, _ = three_blocks
    sizes = _count_calls(monkeypatch, ST, "decode_seq_qual_raw_blocks")
    assert tapi.decode_fastq(enc_j, device="cpu") == data
    assert sizes == [3]
    sizes.clear()
    monkeypatch.setattr(ST, "CPU_BUDGET", 1)
    assert tapi.decode_fastq(enc_j, device="cpu") == data
    assert sizes == [1, 1, 1]


def test_sliced_overflow_reruns_every_slice(three_blocks, monkeypatch):
    """The host-pack path with no room in the optimistic chunk buffers, so
    every stream's emax passes them: each SEQ/QUAL stream of the three
    blocks is coded again with hard buffers, whole, in one launch of
    the overflowed blocks, and the container is still the JAX
    package's."""
    data, enc_j, _ = three_blocks
    chunk_bytes = ST._chunk_bytes
    monkeypatch.setattr(TPN, "_MAX_SPAN", 1)
    monkeypatch.setattr(ST, "_chunk_bytes",
                        lambda depth, hard: chunk_bytes(depth, hard)
                        if hard else 0)
    calls, fn = [], CT.lane_encode_blocks

    def spy(items, kind, geom, CB):
        out = fn(items, kind, geom, CB)
        if kind in ("qual", "seq"):
            assert all(o[1].shape[0] == it.NC for it, o in zip(items, out))
            calls.extend([(kind, CB)] * len(items))
        return out
    monkeypatch.setattr(CT, "lane_encode_blocks", spy)
    assert tapi.encode_fastq(data, device="cpu", level=3, **KW) == enc_j
    # QUAL and SEQ of each of the three blocks, optimistic then hard
    hard = {k: chunk_bytes(d, True) for k, d in (("qual", 6), ("seq", 2))}
    assert sorted(calls) == sorted([(k, CB) for k in ("qual", "seq")
                                    for CB in (0, hard[k])] * 3)
