"""The port's NumPy oracle (slimfastq_tpu_torch.ops.ranger's coder half,
ops/streams_np), its read-ID model (models/readid) and the oracle backend
(``backend="oracle"``, ``--backend oracle``) against the JAX package's
ops/ranger_np, ops/streams_np, models/readid and ``backend=streams_np``:
every payload byte, every decoded symbol and every container byte equal."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.config import config_for_level as jconfig
from slimfastq_tpu.models import readid as JR
from slimfastq_tpu.ops import ranger_np as JRN
from slimfastq_tpu.ops import streams_np as JS
from slimfastq_tpu_torch import api, cli
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.models import readid as TR
from slimfastq_tpu_torch.ops import coder_torch, compact_torch, ranger
from slimfastq_tpu_torch.ops import streams_np as TS
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

SMALL = dict(lanes=32, aux_lanes=8, block_records=256)


def test_format_constants_equal_reference():
    for name in ("TOP", "BOT", "PROB_BITS", "PROB_ONE", "PROB_INIT",
                 "PROB_MIN", "PROB_MAX", "CAP_LOG2", "CNT_SHIFT",
                 "RENORM_ITERS", "FLUSH_BYTES", "STEP_BUCKET", "MASK32"):
        assert int(getattr(ranger, name)) == int(getattr(JRN, name)), name
    for S in (0, 1, 255, 256, 257, 6400):
        assert ranger.pad_steps(S) == JRN.pad_steps(S)
        assert ranger.worst_case_bytes(S * 6) == JRN.worst_case_bytes(S * 6)
    c = np.arange(1, 1025, dtype=np.int32)
    assert np.array_equal(ranger.ceil_log2_counts(c),
                          JRN.ceil_log2_counts(c))


def _layout(rng, W, S, reads_per_lane, maxlen):
    """Per-lane record lengths [Rpl, W] whose lanes fill at most S steps,
    and the (counts, pos, reset) both oracles derive from them."""
    ll = rng.integers(0, maxlen + 1, size=(reads_per_lane, W))
    ll = np.minimum(ll, S // reads_per_lane)
    counts = ll.sum(axis=0)
    steps = int(counts.max())
    pos, reset = TS.build_pos_reset(ll, steps)
    jpos, jreset = JS.build_pos_reset(ll, steps)
    assert np.array_equal(pos, jpos) and np.array_equal(reset, jreset)
    return counts, steps, pos, reset


def _geoms(level, kind, **changes):
    pick = {"seq": "seq", "qual": "qual", "byte": "bytes_", "flag": "flags"}
    tg = getattr(config_for_level(level), pick[kind])
    jg = getattr(jconfig(level), pick[kind])
    return replace(tg, **changes), replace(jg, **changes)


# (level, kind, geometry changes, with match-span flags)
STREAMS = {
    "qual-d6": (3, "qual", dict(depth=6), False),
    "qual-d7": (3, "qual", dict(depth=7), False),
    "qual-d6-delta": (4, "qual", dict(depth=6), False),
    "qual-d7-delta": (4, "qual", dict(depth=7), False),
    "seq-o10": (3, "seq", {}, False),
    "seq-o11-mflag": (4, "seq", {}, True),
    "seq-o10-mflag": (4, "seq", dict(order=10), True),
    "byte": (3, "byte", {}, False),
    "flag": (3, "flag", {}, False),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_oracle_equals_reference(case):
    """encode_stream and decode_stream of the port's oracle against the
    JAX package's, on the same inputs (pos, reset and, for SEQ with the
    match family, the match-span flags)."""
    level, kind, changes, match = STREAMS[case]
    tg, jg = _geoms(level, kind, **changes)
    rng = np.random.default_rng(len(case))
    W = 16
    if kind in ("seq", "qual"):
        counts, S, pos, reset = _layout(rng, W, 300, 4, 80)
        hi = 4 if kind == "seq" else 1 << tg.depth
        syms = rng.integers(0, hi, size=(S, W)).astype(np.uint32)
    else:
        S = 300
        counts = rng.integers(0, S + 1, size=W)
        counts[3] = 0
        syms = rng.integers(0, 256 if kind == "byte" else 2,
                            size=(S, W)).astype(np.uint32)
        pos = reset = None
    syms[np.arange(S)[:, None] >= counts[None, :]] = 0
    mflag = None
    if match:
        mflag = ((pos >= 10) & (pos < 60)).astype(np.uint32)
    kw = dict(pos=pos, reset=reset, mflag=mflag)
    payload, lens = TS.encode_stream(kind, tg, syms, counts, **kw)
    jpayload, jlens = JS.encode_stream(kind, jg, syms, counts, **kw)
    assert np.array_equal(lens, jlens)
    assert np.array_equal(payload, jpayload)
    assert lens.sum() > 0
    back = TS.decode_stream(kind, tg, payload, lens, counts, S, **kw)
    assert np.array_equal(back, JS.decode_stream(kind, jg, payload, lens,
                                                 counts, S, **kw))
    assert np.array_equal(back, syms)


def test_readid_equals_reference():
    """The cases of tests/test_readid.py through both copies."""
    for s in (b"SIM01:23:H7QQQ:1:1101:1000:2000", b"", b"123", b"a1b22"):
        assert TR.tokenize(s) == JR.tokenize(s)
    pairs = [(b"SIM:1:1101:1000:2000", b"SIM:1:1101:1003:2001"),
             (b"run007x", b"run008x"), (b"t09", b"t010"),
             (b"a:1:2", b"a:1"), (b"a:1", b"b:1"),
             (b"x" + b"9" * 30 + b":1", b"x" + b"9" * 30 + b":2")]
    for prev, cur in pairs:
        d = TR.try_delta(prev, cur)
        assert d == JR.try_delta(prev, cur)
        if d is not None:
            assert TR.apply_delta(prev, d) == cur
    ids = [b"SIM:1:1101:1000:2000", b"SIM:1:1101:1004:2001",
           b"totally different", b"SIM:1:1101:1010:2003",
           b"SRR1.100 x", b"SRR1.164 x", b"a" + b"9" * 30 + b".5",
           b"a" + b"9" * 30 + b".13"]
    for bias in (0, 8, 64):
        outs = []
        for M in (TR, JR):
            delta, exc, flags = bytearray(), bytearray(), []
            for i, cur in enumerate(ids):
                flags.append(M.encode_record_id(ids[i - 1] if i else None,
                                                cur, delta, exc,
                                                delta_bias=bias))
            outs.append((flags, bytes(delta), bytes(exc)))
        assert outs[0] == outs[1]
        flags, delta, exc = outs[0]
        got, dpos, xpos = [], 0, 0
        for i, f in enumerate(flags):
            rid, dpos, xpos = TR.decode_record_id(got[i - 1] if i else None,
                                                  f, delta, dpos, exc, xpos,
                                                  delta_bias=bias)
            got.append(rid)
        assert got == ids


@pytest.mark.parametrize("level", [1, 3])
def test_oracle_backend_equals_reference(level):
    """backend="oracle" (the native pipeline, every stream on the NumPy
    oracle) gives the JAX package's container with backend=streams_np,
    and each side decodes the other's."""
    data = synth_fastq(120, read_len=50, seed=level, var_len=True,
                       n_rate=0.02)
    enc = api.encode_fastq(data, level=level, backend="oracle", **SMALL)
    assert enc == japi.encode_fastq(data, level=level, backend=JS,
                                    **SMALL)
    assert api.decode_fastq(enc, backend="oracle") == data
    assert japi.decode_fastq(enc, backend=JS) == data


def test_oracle_touches_no_device(monkeypatch):
    """The oracle asks for no device and launches no kernel: with every
    device entry refused, it still encodes and decodes (a zero-record
    input included)."""
    def refused(*a, **k):
        raise AssertionError("the oracle reached a device entry")
    for mod, name in ((api, "resolve_device"),
                      (coder_torch, "lane_encode_blocks"),
                      (coder_torch, "lane_decode_blocks"),
                      (compact_torch, "compact_streams_dev")):
        monkeypatch.setattr(mod, name, refused)
    for data in (synth_fastq(40, read_len=30, seed=2), b""):
        enc = api.encode_fastq(data, backend="oracle", device="cuda",
                               **SMALL)
        assert api.decode_fastq(enc, backend="oracle",
                                device="cuda") == data
    with pytest.raises(ValueError, match="unknown backend"):
        api.encode_fastq(b"", backend="jax")


def test_cli_backend_oracle(tmp_path, capsys):
    """sfq-torch --backend oracle round-trips without a card (--device
    is ignored), streaming too, and refuses --sharded with exit 2."""
    src = tmp_path / "in.fq"
    src.write_bytes(synth_fastq(40, read_len=30, seed=5, var_len=True,
                                n_rate=0.02))
    enc, back, s_enc = (str(tmp_path / n) for n in ("o.sfq", "b.fq",
                                                     "s.sfq"))
    br = ["--block-records", "24"]
    assert cli.main([str(src), "-o", enc, "--backend", "oracle", *br]) == 0
    assert cli.main(["-d", enc, "-o", back, "--backend", "oracle"]) == 0
    assert open(back, "rb").read() == src.read_bytes()
    assert cli.main([str(src), "-o", s_enc, "--backend", "oracle",
                     "--streaming", *br]) == 0
    assert open(s_enc, "rb").read() == open(enc, "rb").read()
    assert cli.main(["-d", enc, "-o", back, "-f", "--backend", "oracle",
                     "--streaming"]) == 0
    assert open(back, "rb").read() == src.read_bytes()
    capsys.readouterr()
    assert cli.main([str(src), "-o", enc, "-f", "--backend", "oracle",
                     "--sharded"]) == 2
    assert "--sharded requires the torch backend" in capsys.readouterr().err
    assert os.path.getsize(enc) > 0
