"""The port's pure-Python host pipeline (slimfastq_tpu_torch.pipeline, the
``use_native=False`` paths of api and parallel.sharded) and its device
binding (streams_torch.DeviceBackend, the per-stream surface with
match-span flags) against the JAX package's pipeline.py, api and
streams_np on the CPU: every modelled symbol, payload byte and container
byte equal, and each side decodes the other's containers."""

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu import pipeline as JP
from slimfastq_tpu.config import config_for_level as jconfig
from slimfastq_tpu.ops import streams_np as JS
from slimfastq_tpu_torch import api, pipeline
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.models.matcher import MATCH_CHUNK
from slimfastq_tpu_torch.ops import streams_torch as ST
from slimfastq_tpu_torch.parallel import sharded
from slimfastq_tpu_torch.utils.fastq import parse_fastq_bytes
from slimfastq_tpu_torch.utils.synth import corpus, synth_fastq

torch.set_num_threads(1)

SMALL = dict(lanes=32, aux_lanes=8, block_records=256)


def _id_exceptions(n: int) -> bytes:
    """Reads whose IDs break the token structure now and then and whose
    plus lines are neither plain nor a copy of the ID."""
    recs = []
    for r in range(n):
        rid = b"@r%d:%d" % (r, 7 * r) if r % 5 else b"@odd id %d x" % r
        plus = b"+" if r % 3 else (b"+" + rid[1:] if r % 2 else b"+note")
        recs.append(rid + b"\nACGTNACG\n" + plus + b"\nIIII#III\n")
    return b"".join(recs)


# (input, level, geometry)
JOBS = {
    "l1": (lambda: synth_fastq(90, read_len=40, seed=1), 1, SMALL),
    "l2": (lambda: synth_fastq(90, read_len=40, seed=2), 2, SMALL),
    "l3-var-len": (lambda: synth_fastq(90, read_len=60, seed=3,
                                       var_len=True), 3, SMALL),
    "l3-n-rich": (lambda: synth_fastq(90, read_len=40, seed=4,
                                      n_rate=0.3, n_burst=True), 3, SMALL),
    "l3-id-exceptions": (lambda: _id_exceptions(70), 3, SMALL),
    "l3-empty": (lambda: b"", 3, SMALL),
    "l4-no-trial": (lambda: synth_fastq(90, read_len=40, seed=5), 4, SMALL),
    "l4-trials": (lambda: corpus("novaseq", MATCH_CHUNK + 76),
                  4, dict(lanes=256, aux_lanes=16)),
}


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b)) and \
            np.asarray(a).dtype == np.asarray(b).dtype
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if hasattr(a, "__dataclass_fields__"):
        return a.__class__.__name__ == b.__class__.__name__ and \
            _equal(vars(a), vars(b))
    return a == b


@pytest.mark.parametrize("case", list(JOBS))
def test_stream_jobs_equals_reference(case):
    """pipeline.stream_jobs of the port and of the JAX package: every
    stream's (kind, geometry, symbols, counts, pos, reset), the block's
    n, minq and qual depth, and the v5 decisions (SEQ order, qual delta,
    each match trial's rewritten SEQ, MATCH lanes and flags)."""
    make, level, kw = JOBS[case]
    batch = parse_fastq_bytes(make())
    tcfg, jcfg = config_for_level(level, **kw), jconfig(level, **kw)
    got = pipeline.stream_jobs(batch, tcfg)
    want = JP.stream_jobs(batch, jcfg)
    assert _equal(got, want)
    if case == "l4-trials":
        assert len(got[4]["match_trials"]) == 2


def test_python_pipeline_equals_reference():
    """encode_fastq(use_native=False) on the port (each stream through
    Kernels E/C or D's plain versions) equals the JAX package's
    encode_fastq(use_native=False) and the port's native container; each
    side decodes the other's (several blocks, ragged lengths, Ns)."""
    data = synth_fastq(150, read_len=50, seed=7, var_len=True, n_rate=0.02)
    kw = dict(level=3, lanes=32, aux_lanes=8, block_records=100)
    enc = api.encode_fastq(data, device="cpu", use_native=False, **kw)
    assert enc == japi.encode_fastq(data, backend=JS, use_native=False,
                                    **kw)
    assert enc == api.encode_fastq(data, device="cpu", **kw)
    assert api.decode_fastq(enc, device="cpu", use_native=False) == data
    assert japi.decode_fastq(enc, backend=JS) == data


def test_python_pipeline_needs_a_card(monkeypatch):
    """With no card and no device="cpu", use_native=False raises as every
    entry point does; it never falls back to the CPU or to the oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: api.encode_fastq(b"", use_native=False),
                 lambda: api.decode_fastq(api.encode_fastq(
                     b"", backend="oracle"), use_native=False),
                 lambda: sharded.encode_fastq_sharded(
                     b"", config_for_level(3), use_native=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_streams_take_match_flags():
    """streams_torch.encode_stream / decode_stream and their _blocks forms
    (DeviceBackend) with a SEQ stream of the match-context family give
    the JAX package's oracle bytes; a window of a flagged and an
    unflagged block gives each block's own bytes."""
    cfg, jcfg = config_for_level(4), jconfig(4)
    rng = np.random.default_rng(11)
    W, S = 16, 300
    ll = rng.integers(20, 80, size=(4, W))
    counts = ll.sum(axis=0)
    S = int(counts.max())
    pos, reset = JS.build_pos_reset(ll, S)
    syms = rng.integers(0, 4, size=(S, W)).astype(np.uint32)
    syms[np.arange(S)[:, None] >= counts[None, :]] = 0
    mflag = ((pos >= 5) & (pos < 40)).astype(np.uint32)
    dev = ST.DeviceBackend("cpu")
    kw = dict(pos=pos, reset=reset, mflag=mflag)
    payload, lens = dev.encode_stream("seq", cfg.seq, syms, counts, **kw)
    jp, jl = JS.encode_stream("seq", jcfg.seq, syms, counts, **kw)
    assert np.array_equal(lens, jl) and np.array_equal(payload, jp)
    plain = dev.encode_stream("seq", cfg.seq, syms, counts, pos=pos,
                              reset=reset)
    assert not np.array_equal(plain[0], payload)
    back = dev.decode_stream("seq", cfg.seq, payload, lens, counts, S, **kw)
    assert np.array_equal(back, syms)
    both = dev.encode_stream_blocks("seq", cfg.seq, [syms, syms],
                                    [counts, counts], [pos, pos],
                                    [reset, reset], [mflag, None])
    for (p, n), (p1, n1) in zip(both, [(payload, lens), plain]):
        assert np.array_equal(p, p1) and np.array_equal(n, n1)
    dec = dev.decode_stream_blocks(
        "seq", cfg.seq, [payload, plain[0]], [lens, plain[1]],
        [counts, counts], [S, S], [pos, pos], [reset, reset], [mflag, None])
    assert all(np.array_equal(d, syms) for d in dec)
