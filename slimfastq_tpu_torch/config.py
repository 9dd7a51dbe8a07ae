"""Codec configuration: compression levels 1-4 map to context-model geometry.

Mirrors the capability of slimfastq's level knob (SURVEY.md §2 "Config /
flags": levels select context-model depth/table sizes in the sequence and
quality codecs) re-expressed as explicit dataclasses. TPU-side knobs (lanes,
block size) deliberately do NOT affect output bytes except through the
documented block structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class QualGeom:
    """Quality-stream model geometry.

    Context = prev qual (q1, full) | quantised prev-prev qual (q2)
    | quantised q1-q2 delta | position bucket — the fqzcomp/slimfastq
    quality-context family (SURVEY.md §2 "Quality codec") plus the
    level-4 delta ingredient.

    delta code (2 bits, frozen format rule when delta_bits=2):
      0: q1 == q2;  1: 0 < q1-q2 <= 3;  2: -3 <= q1-q2 < 0;  3: |q1-q2| > 3
    """
    depth: int = 6          # bits per symbol (6 => 64-symbol alphabet)
    q2_bits: int = 3        # quantised second-order qual context bits
    pos_bits: int = 4       # position-bucket bits
    pos_shift: int = 3      # bucket = min(pos >> shift, 2^pos_bits - 1)
    rate: int = 5           # adaptation shift
    delta_bits: int = 0     # 0 or 2: quantised q1-q2 delta context bits
    rate_lo: int = 0        # format v4 visit-count warm-up: cold entries
    #   adapt at shift min(rate, rate_lo + ceil_log2(visits+1)); 0 = off
    #   (ranger_np.table_update docstring is the frozen law)

    @property
    def num_ctx(self) -> int:
        return 1 << (self.depth + self.q2_bits + self.delta_bits
                     + self.pos_bits)

    @property
    def sac_base(self) -> int:
        return self.num_ctx * ((1 << self.depth) - 1)

    @property
    def table_size(self) -> int:
        # +1 sacrificial context row for pad-coded lockstep steps
        return (self.num_ctx + 1) * ((1 << self.depth) - 1)


@dataclass(frozen=True)
class SeqGeom:
    """Sequence-stream model geometry: order-k 2-bit base context
    (SURVEY.md §2 "Sequence codec").

    Partial contexts (the first j < k bases of a read) are disambiguated
    exactly: ctx = rolled_bases + (4^j - 1)/3, i.e. every node of the depth-k
    4-ary prefix tree owns a table row, so a fresh read never aliases a run
    of A's. tree_ctx = (4^(k+1) - 1)/3.

    match_bits (format v5): when > 0, the context space grows by a
    dedicated *match family* of 2^match_bits contexts used at positions
    inside an accepted long-range match span (models/matcher.py):
    ctx = tree_ctx + (h & (2^match_bits - 1)) where h is the rolling
    2-bit coded-symbol (e-symbol) history. e-spans are near-zero runs
    with occasional mismatches; routing them through the genome tree cost
    span-entry and post-mismatch pollution worth 8-16% of the SEQ stream
    on coverage data (tools/probe_matchctx.py).
    """
    order: int = 10         # k previous bases of context
    rate: int = 4
    rate_lo: int = 0        # format v4 visit-count warm-up (see QualGeom)
    match_bits: int = 0     # v5 dedicated match-context family (0 = none)

    depth: int = 2          # 2 bits per base — fixed

    @property
    def tree_ctx(self) -> int:
        return ((1 << (2 * (self.order + 1))) - 1) // 3

    @property
    def num_ctx(self) -> int:
        return self.tree_ctx + ((1 << self.match_bits)
                                if self.match_bits else 0)

    @property
    def sac_base(self) -> int:
        return self.num_ctx * 3

    @property
    def table_size(self) -> int:
        return (self.num_ctx + 1) * 3


@dataclass(frozen=True)
class ByteGeom:
    """Generic byte-stream model: 8-bit tree, order-0/1 previous-byte ctx."""
    order: int = 1
    rate: int = 4

    depth: int = 8

    @property
    def num_ctx(self) -> int:
        return 256 if self.order else 1

    @property
    def sac_base(self) -> int:
        return self.num_ctx * 255

    @property
    def table_size(self) -> int:
        return (self.num_ctx + 1) * 255


@dataclass(frozen=True)
class FlagGeom:
    """1-bit flag stream: context = last `hist_bits` flags."""
    hist_bits: int = 2
    rate: int = 4

    depth: int = 1

    @property
    def num_ctx(self) -> int:
        return 1 << self.hist_bits

    @property
    def sac_base(self) -> int:
        return self.num_ctx

    @property
    def table_size(self) -> int:
        return self.num_ctx + 1


@dataclass(frozen=True)
class CodecConfig:
    """Full codec configuration for one container."""
    level: int = 3
    # container format version this config decodes/encodes (container.py
    # VERSION). Encoding always writes the current version; older values
    # appear only on configs read from legacy containers. fmt=1 (round
    # 1): per-base SEQX exceptions, un-CRC'd header/index, no block
    # length prefix. fmt=2 (round 2): ID/LEN delta baseline is the
    # globally previous record r-1 (one serial decode chain). fmt=3:
    # baseline is the aux-lane-local previous record r-Wa, making ID/LEN
    # decode lane-parallel. fmt=4: visit-count adaptation warm-up.
    # fmt=5: MATCH stream + per-block SEQ order fallback (models/
    # matcher.py).
    fmt: int = 5
    # encoder-side only (never needed for decode — v5 blocks are
    # self-describing via their flags byte): run the long-range read
    # matcher and trial-code the SEQ stream with the e-transform.
    # Costs host match-search time; pays on high-coverage data
    # (BASELINE.md corpus table). On by default at level 4.
    match: bool = False
    qual: QualGeom = field(default_factory=QualGeom)
    seq: SeqGeom = field(default_factory=SeqGeom)
    bytes_: ByteGeom = field(default_factory=ByteGeom)
    flags: FlagGeom = field(default_factory=FlagGeom)
    # TPU/block knobs — affect parallel layout only, not per-lane bit streams
    # (bigger blocks amortise kernel latency AND give adaptive tables more
    # data: measured 33 Gsym/s at S=6400 vs 13 Gsym/s at S=2048, W=1024)
    block_records: int = 1 << 16   # records per independently-decodable block
    lanes: int = 1024              # interleaved lanes for qual/seq streams
    aux_lanes: int = 64            # lanes for small id/length/flag streams


# Level table: ratio/speed trade-off analogous to slimfastq -1..-4
# (SURVEY.md §5 "Config / flag system"). Larger level = bigger context
# tables = better ratio. Levels 1-3 keep every table VMEM-resident
# (<= ~4 MB) so the hot loop never touches HBM; level 4 trades speed for
# maximum context depth.
# Quality geometry per level follows the measured sweep (full previous-two
# qualities beat quantised-q2 + fine position buckets by ~8%): see
# BASELINE.md.
# Round-3 (format v4) rate_lo values are measured: tools/sweep_cold.py +
# the rate_lo combo sweep (commit message has the tables). Qual rate_lo=1
# everywhere: -3..-12% on 500-read corpora, -0.9% at 16k, no warm cost.
# Seq: L3's order-10 warm-up (rate_lo=1) is the big one — 64k-block ratio
# 5.5914 -> 6.0181 and -13..-20% on small corpora; L1/L2's shallower
# orders are warm sooner and prefer rate_lo=2.
LEVELS: dict[int, CodecConfig] = {
    1: CodecConfig(level=1,
                   qual=QualGeom(q2_bits=0, pos_bits=2, pos_shift=5, rate=5,
                                 rate_lo=1),
                   seq=SeqGeom(order=5, rate=3, rate_lo=2)),
    2: CodecConfig(level=2,
                   qual=QualGeom(q2_bits=4, pos_bits=1, pos_shift=6, rate=5,
                                 rate_lo=1),
                   seq=SeqGeom(order=7, rate=3, rate_lo=2)),
    3: CodecConfig(level=3,
                   qual=QualGeom(q2_bits=6, pos_bits=1, pos_shift=6, rate=5,
                                 rate_lo=1),
                   seq=SeqGeom(order=10, rate=3, rate_lo=1)),
    # L4 = L3 qual context + the q1-q2 delta ingredient + one more base of
    # seq context. With the full previous qual in-context (q2_bits=6 at
    # depth 6) the delta code is redundant and the qual bytes are identical
    # to L3 (measured); at depth 7/8 (wide quality alphabets) q2 is
    # quantised and the delta adds real information. Deeper contexts
    # (q3, finer position) LOSE on 16k-read blocks: measured conditional
    # entropy gain <= 0.02 bit/qual vs ~3x the cold-table learning cost
    # (the coded-vs-entropy gap is ~0.23 bit/qual of adaptation cost).
    # L4 seq: order-11 with the v4 warm-up (rate 3, rate_lo 1) — wins
    # every shape >= 16k (64k x W=1024: ratio 6.3959 vs warm L3's
    # 6.0181; 16k: -2.5% vs fixed rate 1), and is within ~1% of warm L3
    # on the 500-read toy corpora, where 500 reads cannot warm an
    # order-11 table under ANY schedule (measured bound: fixed rate 1 —
    # the fastest possible adaptation — still loses to warm L3 there).
    4: CodecConfig(level=4, match=True,
                   qual=QualGeom(q2_bits=6, delta_bits=2, pos_bits=1,
                                 pos_shift=6, rate=5, rate_lo=1),
                   seq=SeqGeom(order=11, rate=3, rate_lo=1,
                               match_bits=4)),
}

# FROZEN: the level table as of the final container-format-1 build.
# v1 headers carry only the level byte (no geometry), so decoding a v1
# container MUST reconstruct exactly these geometries forever — editing
# LEVELS above must never touch this table. Pinned by the v1 golden
# fixture plus per-level v1 decode tests.
LEVELS_V1: dict[int, CodecConfig] = {
    1: CodecConfig(level=1,
                   qual=QualGeom(q2_bits=0, pos_bits=2, pos_shift=5, rate=5),
                   seq=SeqGeom(order=5, rate=3)),
    2: CodecConfig(level=2,
                   qual=QualGeom(q2_bits=4, pos_bits=1, pos_shift=6, rate=5),
                   seq=SeqGeom(order=7, rate=3)),
    3: CodecConfig(level=3,
                   qual=QualGeom(q2_bits=6, pos_bits=1, pos_shift=6, rate=5),
                   seq=SeqGeom(order=10, rate=3)),
    4: CodecConfig(level=4,
                   qual=QualGeom(q2_bits=6, pos_bits=2, pos_shift=5, rate=5),
                   seq=SeqGeom(order=11, rate=3)),
}


def config_for_level(level: int, **overrides) -> CodecConfig:
    base = LEVELS[level]
    if overrides:
        from dataclasses import replace
        base = replace(base, **overrides)
    return base


_GEOMS = {"qual": QualGeom, "seq": SeqGeom, "bytes_": ByteGeom,
          "flags": FlagGeom}


def from_reference(d: dict) -> CodecConfig:
    """CodecConfig from a ``dataclasses.asdict()`` of the JAX package's
    CodecConfig (the two are field-for-field the same), so both packages
    code with one geometry."""
    kw = {k: (_GEOMS[k](**v) if k in _GEOMS else v) for k, v in d.items()}
    return CodecConfig(**kw)
