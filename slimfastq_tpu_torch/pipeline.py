"""Block data model, stream inventory and lane layout.

A *block* is a fixed-record-count, independently decodable unit. Record ->
lane mapping is round-robin (record r -> lane r % W, slot r // W), so lanes
stay balanced. The block pipeline itself lives in pipeline_native.py; this
module keeps the pieces of the format every path shares.

Stream inventory per block (fixed order):
  LEN   byte  — svarint(read_len - prev_len)
  FLAG  flag  — 3 bits/record: [id_exception, plus_plain, plus_is_idcopy]
  IDD   byte  — svarint digit-token deltas for flag=0 IDs
  IDX   byte  — varint-length-prefixed exception IDs and plus lines
  SEQX  byte  — non-ACGT exceptions: varint(gap in global base index) + char
  SEQ   2bit  — bases (exceptions coded as A), order-k rolling context
  QUAL  6/7bit— qualities biased by per-block minq
  MATCH byte  — (format v5) long-range read-match descriptors; when a
          block's flags bit0 is set, SEQ symbols are e-transformed over
          matched spans. Format v5 blocks also carry the SEQ context order
          actually used (seq_order; 0 = the geometry default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STREAMS = ("LEN", "FLAG", "IDD", "IDX", "SEQX", "SEQ", "QUAL")
STREAMS_V5 = STREAMS + ("MATCH",)

MATCH_USED = 1     # EncodedBlock.flags bit0: SEQ symbols are e-transformed
QUAL_NODELTA = 2   # flags bit1: QUAL coded with delta_bits=0 (small block)


def streams_for(fmt: int):
    """Stream inventory for a container format version."""
    return STREAMS_V5 if fmt >= 5 else STREAMS


_BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_TO_CODE[_b] = _i
_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class EncodedStream:
    sym_counts: np.ndarray  # int64[W] symbols per lane
    lane_lens: np.ndarray   # int64[W] compressed bytes per lane
    payload: np.ndarray     # uint8[W, maxlen]


@dataclass
class EncodedBlock:
    num_records: int
    minq: int
    qual_depth: int
    streams: dict[str, EncodedStream]
    flags: int = 0      # v5: bit0 MATCH_USED
    seq_order: int = 0  # v5: SEQ context order used (0 = geometry default)

    def stream_order(self):
        return STREAMS_V5 if "MATCH" in self.streams else STREAMS


def _lane_lengths_matrix(lengths: np.ndarray, W: int) -> np.ndarray:
    """[Rpl, W] per-lane record lengths, 0-padded. Record r lands at
    (r // W, r % W), which flattens to index r — a pad + reshape."""
    n = len(lengths)
    Rpl = (n + W - 1) // W if n else 0
    mat = np.zeros((Rpl, W), dtype=np.int64)
    mat.reshape(-1)[:n] = lengths
    return mat
