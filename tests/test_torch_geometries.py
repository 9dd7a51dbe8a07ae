"""Every geometry the container header names, on the CPU. The header
carries QUAL's and SEQ's `rate` / `rate_lo` and FLAG's `hist_bits`; the
JAX package codes any of them. Where `rate - rate_lo` reaches 5 the
warm-up's visit cap reaches 16 (7 / 2) and up to 512 (14 / 1, the most
the law's saturating ceil_log2 allows), which the kernels' 16-bit entry
(a 4-bit visit count) cannot hold: such a geometry takes 32-bit entries
(coder_torch.entry_bytes), in the kernels and in the plain encode's
tables carried from slice to slice. FLAG at 17 history bits has a
depth-1 table past one CTA's shared memory, which Kernel D keeps in
device memory. Here: the plain encode over several slices against the
lockstep form and the JAX package's NumPy oracle; the port's containers
against the JAX package's, each decoding the other's; the layout each
geometry takes. The kernels at these geometries run on the card
(tests/test_torch_cuda.py, chip_smoke.py's `geometries` phase)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu import config as jconfig
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_np as JNP
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import compact_torch as CC
from slimfastq_tpu_torch.ops import encode_torch as ET
from slimfastq_tpu_torch.ops import streams_torch as ST
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

# (stream, field changes from level 3, visit cap)
GEOMS = {
    "qual-cap16": ("qual", dict(rate=7, rate_lo=2), 16),
    "qual-cap512": ("qual", dict(rate=14, rate_lo=1), 512),
    "seq-cap16": ("seq", dict(rate=7, rate_lo=2), 16),
    "seq-cap512": ("seq", dict(rate=14, rate_lo=1), 512),
    "flag-hist17": ("flags", dict(hist_bits=17), 0),
}


def _cfg(module, case):
    """Level 3 of `module`'s LEVELS with the case's one stream changed."""
    field, changes, _ = GEOMS[case]
    base = module.LEVELS[3]
    return replace(base, **{field: replace(getattr(base, field), **changes)})


def _stream(kind: str, W: int, Sp: int, seed: int):
    """[Sp, W] symbols of 100-symbol reads that all start together (each
    read start puts every lane on one entry, so visits pile up fast), with
    pos / reset and counts."""
    rng = np.random.default_rng(seed)
    if kind == "seq":
        syms = rng.integers(0, 4, size=(Sp, W))
    else:
        syms = np.clip(32 + np.cumsum(rng.integers(-2, 3, (Sp, W)), axis=0),
                       0, 63)
    pos, reset = JNP.build_pos_reset(
        np.full((Sp // 100 + 1, W), 100, dtype=np.int64), Sp)
    return syms.astype(np.uint8), np.full(W, Sp, dtype=np.int64), pos, reset


@pytest.mark.parametrize("case", [c for c in GEOMS if GEOMS[c][2]])
def test_slices_keep_the_visit_count(case, monkeypatch):
    """The fault: the plain encode carried its tables from slice to slice
    in 16-bit entries, so a visit count of 16 and more came back as 0 at
    the next slice (silently wrong bytes once a stream spans slices).
    One stream of 64 lanes and 256 steps in slices of 6,144 decisions
    (at least 3): the decoupled encode equals the lockstep form and the
    JAX package's NumPy oracle byte for byte."""
    kind, _, cap = GEOMS[case]
    geom = getattr(_cfg(tconfig, case), kind)
    assert CT.visit_cap(geom) == cap
    W, Sp = 64, 256
    syms, counts, pos, reset = _stream(kind, W, Sp, seed=cap)
    monkeypatch.setattr(ET, "SLICE_DECISIONS", 6144)
    assert Sp * geom.depth > 2 * ET.slice_steps(1, W, Sp * geom.depth)
    t = [torch.from_numpy(x.astype(np.int32)) for x in (counts, pos, reset)]
    item = CT.EncIn(torch.from_numpy(syms), t[1], t[2], t[0])
    CB = ST._chunk_bytes(geom.depth, hard=False)
    got = CT.lane_encode_blocks([item], kind, geom, CB)[0]
    for a, b in zip(got, CT.lane_encode_blocks_plain([item], kind, geom,
                                                     CB)[0]):
        assert torch.equal(a, b)
    ebufs, eptrs, low, _ = got
    totals = eptrs.sum(dim=0)
    com = CC.compact_lanes_plain(ebufs, eptrs, int(totals.max()))
    pay, lens = ST._flush_append(com[0].numpy(),
                                 totals.numpy().astype(np.int64),
                                 low.numpy().view(np.uint32), counts)
    want = JNP.encode_stream(kind, getattr(_cfg(jconfig, case), kind), syms,
                             counts, pos, reset)
    assert np.array_equal(lens, want[1]) and np.array_equal(pay, want[0])
    assert CT.entry_bytes(geom) == 4


@pytest.mark.parametrize("case", list(GEOMS))
def test_containers_equal_the_reference(case, monkeypatch):
    """2,000 reads of 40 bases at each geometry (QUAL's and SEQ's 80
    steps padded to 256), in slices of 64 bit-steps (24 and 8 a stream):
    the port's container equals the JAX package's, and each package
    decodes the other's."""
    data = synth_fastq(2000, read_len=40, seed=1, var_len=False,
                       n_rate=0.0005)
    monkeypatch.setattr(ET, "SLICE_DECISIONS", 64 * 1024)
    ref = japi.encode_fastq(data, cfg=_cfg(jconfig, case))
    got = tapi.encode_fastq(data, cfg=_cfg(tconfig, case), device="cpu")
    assert got == ref
    assert tapi.decode_fastq(ref, device="cpu") == data
    assert japi.decode_fastq(got) == data


def test_8000_reads_at_qual_cap16():
    """8,000 reads of 100 bases at level 3 with QUAL 7 / 2 at the default
    slices (its QUAL stream runs in 2): 310,316 bytes, the JAX package's,
    and they decode back to the input (before the repair the port wrote
    311,938 bytes that decoded to other reads without an error)."""
    data = synth_fastq(8000, read_len=100, seed=0)
    got = tapi.encode_fastq(data, cfg=_cfg(tconfig, "qual-cap16"),
                            device="cpu")
    assert len(got) == 310316
    assert got == japi.encode_fastq(data, cfg=_cfg(jconfig, "qual-cap16"))
    assert tapi.decode_fastq(got, device="cpu") == data


def test_visit_cap_closed_form():
    """visit_cap's closed form is the least visit count whose warm-up
    shift (ranger_np.table_update's, from the JAX package) is the
    saturated one, for every rate_lo < rate up to 16."""
    vis = np.arange(1025)
    lg = R.ceil_log2_counts(np.minimum(vis, 1024) + 1)
    for rate in range(2, 17):
        for rate_lo in range(1, rate):
            g = replace(tconfig.LEVELS[3].seq, rate=rate, rate_lo=rate_lo)
            shift = np.minimum(rate, rate_lo + lg)
            least = int(np.argmax(shift == shift[-1]))
            assert CT.visit_cap(g) == least <= 512
    assert CT.visit_cap(replace(tconfig.LEVELS[3].seq, rate_lo=0)) == 0


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_entry_layout_of_each_geometry(level):
    """Every built-in level keeps the 16-bit entry (and so its tables,
    shapes and bytes on the card); caps 16 and 512 take 32 bits, halving
    what shared memory holds; FLAG at 17 history bits keeps 16 bits but
    passes shared memory, and Kernel D takes its depth-1 table in device
    memory, one CTA at 64 aux lanes."""
    for table in (tconfig.LEVELS, tconfig.LEVELS_V1):
        cfg = table[level]
        for g in (cfg.qual, cfg.seq, cfg.bytes_, cfg.flags):
            assert CT.entry_bytes(g) == 2
            assert CT.table_bytes(g) == 2 * g.table_size
            assert CT.lane_state_bytes(g) == 48
    for case, (field, _, cap) in GEOMS.items():
        g = getattr(_cfg(tconfig, case), field)
        assert CT.visit_cap(g) == cap
        eb = 4 if cap else 2
        assert CT.entry_bytes(g) == eb
        assert CT.table_bytes(g) == eb * g.table_size
        assert CT.lane_state_bytes(g) == 32 + 8 * eb
        assert CT.table_in_smem(g) == (
            (eb * g.table_size + 15) // 16 * 16 <= CT.SMEM_LIMIT)
        for W in (64, 1024):
            s = CT.decode_shape(g, W)
            assert s.entry_bytes == eb
            assert (s.table == "smem") == CT.table_in_smem(g)
    # level 3's QUAL and SEQ lie past shared memory in either layout; L1's
    # QUAL fits it in 16 bits and still in 32
    l1q = replace(tconfig.LEVELS[1].qual, rate=7, rate_lo=2)
    assert CT.entry_bytes(l1q) == 4 and CT.table_in_smem(l1q)
    flag = _cfg(tconfig, "flag-hist17").flags
    assert not CT.table_in_smem(flag)
    s = CT.decode_shape(flag, 64)
    assert (s.table, s.padded, s.cluster, s.entries, s.smem_bytes) == (
        "device", False, 1, flag.table_size, 0)
