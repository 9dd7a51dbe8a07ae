"""Host-side FASTQ record parsing/serialisation.

slimfastq's L4 loop reads 4 text lines per record (SURVEY.md §3.1); here the
host parses whole buffers into per-field lists that block assembly converts
to fixed-shape arrays. A C++ fast path can replace this transparently.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FastqBatch:
    ids: list[bytes]      # without leading '@', without newline
    seqs: list[bytes]
    pluses: list[bytes]   # full line-3 content without newline (starts '+')
    quals: list[bytes]

    def __len__(self) -> int:
        return len(self.ids)


def parse_fastq_bytes(data: bytes) -> FastqBatch:
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    n = len(lines)
    if n % 4 != 0:
        raise ValueError(f"FASTQ line count {n} not a multiple of 4")
    ids, seqs, pluses, quals = [], [], [], []
    for i in range(0, n, 4):
        idl = lines[i]
        if not idl.startswith(b"@"):
            raise ValueError(f"record {i // 4}: id line does not start with '@'")
        pl = lines[i + 2]
        if not pl.startswith(b"+"):
            raise ValueError(f"record {i // 4}: line 3 does not start with '+'")
        if len(lines[i + 1]) != len(lines[i + 3]):
            raise ValueError(f"record {i // 4}: seq/qual length mismatch")
        ids.append(idl[1:])
        seqs.append(lines[i + 1])
        pluses.append(pl)
        quals.append(lines[i + 3])
    return FastqBatch(ids, seqs, pluses, quals)


def serialize_fastq(batch: FastqBatch) -> bytes:
    parts = []
    for i in range(len(batch.ids)):
        parts.append(b"@" + batch.ids[i])
        parts.append(batch.seqs[i])
        parts.append(batch.pluses[i])
        parts.append(batch.quals[i])
    return b"\n".join(parts) + b"\n" if parts else b""
