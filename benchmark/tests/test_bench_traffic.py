"""The traffic generator (benchmark/traffic/fastq.py) on the CPU."""

import json
import os
import time

import numpy as np
import pytest
from conftest import BENCH

from reference.check import fastq_records
from traffic import fastq

ILLUMINA = json.load(open(os.path.join(BENCH, "workloads",
                                       "illumina-1m.json")))
HIFI = json.load(open(os.path.join(BENCH, "workloads", "hifi-8k.json")))
SMALL = [dict(ILLUMINA, reads=3000),
         dict(HIFI, reads=40, read_length={"min": 1200, "max": 2100})]


@pytest.mark.parametrize("params", SMALL, ids=["illumina", "hifi"])
def test_same_seed_same_bytes(params):
    a = fastq.make_files(params, 2**31 + 11)
    assert a == fastq.make_files(params, 2**31 + 11)
    b = fastq.make_files(params, 2**31 + 12)
    assert a != b
    # a seed moves the content, never the sizes
    assert [len(x) > 0 for x in a] == [len(x) > 0 for x in b]
    assert np.array_equal(fastq_records(a[0])[2], fastq_records(b[0])[2])


@pytest.mark.parametrize("params", SMALL, ids=["illumina", "hifi"])
def test_records_as_the_workload_states(params):
    data = fastq.make_file(params, 7, 0)
    buf = np.frombuffer(data, dtype=np.uint8)
    soff, qoff, lens = fastq_records(data)
    assert len(lens) == params["reads"]
    spec = params["read_length"]
    if "value" in spec:
        assert (lens == spec["value"]).all()
    else:
        assert lens.min() >= spec["min"] and lens.max() <= spec["max"]
    nl = np.flatnonzero(buf == 10)
    ids = np.concatenate([[0], nl[3::4][:-1] + 1])
    assert (buf[ids] == ord("@")).all()
    assert (buf[nl[1::4] + 1] == ord("+")).all()
    assert (nl[2::4] == nl[1::4] + 2).all()  # the plus line is bare
    seq = np.concatenate([buf[o:o + n] for o, n in zip(soff, lens)])
    qual = np.concatenate([buf[o:o + n] for o, n in zip(qoff, lens)])
    assert set(np.unique(seq).tolist()) <= set(b"ACGTN")
    assert 0 < (seq == ord("N")).mean() < 5 * params["n_rate"] + 0.002
    assert qual.min() >= 33 + 2
    assert qual.max() <= 33 + params["qual_levels"] - 1
    assert (qual[seq == ord("N")] == 33 + 2).all()


def test_a_million_reads_in_seconds():
    """How long one file of the bulk cells takes to make here, beside the
    port's per-read generator (utils.synth.synth_fastq): 1.07 s per 16,384
    reads on this kind of CPU, ~68 s for a million."""
    t = time.perf_counter()
    data = fastq.make_file(ILLUMINA, 5, 0)
    took = time.perf_counter() - t
    print(f"\n1,048,576 reads x 100 bp ({len(data):,} B) in {took:.2f} s; "
          f"synth_fastq's loop: 1.07 s per 16,384 reads (~68 s)")
    assert len(fastq_records(data)[2]) == 1 << 20
