"""Synthetic Illumina-like FASTQ generation for tests and benchmarks
(BASELINE.json configs use e.g. 100k reads at Q40 scale)."""

from __future__ import annotations

import numpy as np


def _synth_genome(rng, size: int) -> np.ndarray:
    """Genome-like base sequence: random backbone + duplicated segments
    (repeats), so resequencing reads share deep k-mer statistics the way
    real Illumina data does."""
    g = rng.integers(0, 4, size=size).astype(np.uint8)
    # plant repeats: copy random segments over other locations
    n_rep = size // 2000
    for _ in range(n_rep):
        L = int(rng.integers(200, 2000))
        src = int(rng.integers(0, max(size - L, 1)))
        dst = int(rng.integers(0, max(size - L, 1)))
        g[dst: dst + L] = g[src: src + L]
    return g


_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G in 2-bit


def synth_fastq(num_reads: int, read_len: int = 100, seed: int = 0,
                var_len: bool = False, n_rate: float = 0.001,
                instrument: bytes = b"SIM01", qual_levels: int = 41,
                genome_size: int | None = None,
                coverage_like: bool = True,
                qual_bins: list[int] | None = None,
                id_style: str = "illumina",
                n_burst: bool = False) -> bytes:
    """Generate Illumina-like FASTQ:
    - IDs: instrument:run:flowcell:lane:tile:x:y with incrementing x/y
    - seq: reads sampled from a shared synthetic genome (fwd/revcomp),
      with sequencing errors and occasional N — so order-k sequence
      contexts have real structure to learn, as on real data
    - qual: position-degrading phred profile with autocorrelation
    """
    rng = np.random.default_rng(seed)
    out = bytearray()
    tile = 1101
    x = 1000
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    if genome_size is None:
        genome_size = max(int(num_reads * read_len // 8), 10 * read_len)
    genome = _synth_genome(rng, genome_size) if coverage_like else None
    # systematic per-cycle quality effects shared by all reads (real
    # Illumina runs have them), so position context is informative
    sys_pos = np.cumsum(rng.normal(0, 0.35, size=read_len + 1))
    sys_pos -= sys_pos.mean()
    sys_pos = np.clip(sys_pos, -4, 4)
    for r in range(num_reads):
        L = read_len if not var_len else int(rng.integers(max(1, read_len // 2),
                                                          read_len + 1))
        x += int(rng.integers(1, 4))
        y = 2000 + (r % 997)
        if id_style == "sra":
            # SRA-normalised IDs: accession.ordinal + comment + length
            rid = b"SRR8899417.%d %d length=%d" % (r + 1, r + 1, L)
        else:
            rid = b"%s:23:H7QQQ:1:%d:%d:%d" % (instrument, tile, x, y)
        if coverage_like and L > 0:
            start = int(rng.integers(0, max(genome_size - L, 1)))
            b_idx = genome[start: start + L].copy()
            if len(b_idx) < L:
                b_idx = np.concatenate(
                    [b_idx, rng.integers(0, 4, L - len(b_idx)).astype(np.uint8)])
            if rng.random() < 0.5:
                b_idx = _COMP[b_idx[::-1]]
            err = rng.random(L) < 0.002  # sequencing errors
            if err.any():
                b_idx[err] = (b_idx[err] + rng.integers(1, 4,
                                                        err.sum())) % 4
        else:
            b_idx = rng.integers(0, 4, size=L).astype(np.uint8)
            rep = rng.random(L) < 0.35
            for i in range(1, L):
                if rep[i]:
                    b_idx[i] = b_idx[i - 1]
        seq = bases[b_idx].copy()
        if n_burst:
            # bursty N-runs (low-quality flow cells drop whole stretches):
            # expected fraction n_rate, runs of 1-30 bases
            nmask = np.zeros(L, dtype=bool)
            n_runs = rng.poisson(n_rate * L / 8.0)
            for _ in range(n_runs):
                s0 = int(rng.integers(0, max(L, 1)))
                nmask[s0: s0 + int(rng.integers(1, 30))] = True
        else:
            nmask = rng.random(L) < n_rate
        seq[nmask] = ord("N")
        # quality: position ramp + shared per-cycle systematics + per-read
        # offset + autocorrelated noise + rare burst dips
        base_q = 38.0 - 8.0 * (np.arange(L) / max(1, L)) ** 2
        base_q += sys_pos[:L] + rng.normal(0, 2.0)
        noise = np.cumsum(rng.normal(0, 0.6, size=L))
        noise -= np.linspace(0, noise[-1] if L else 0.0, L)
        q = base_q + noise
        if L and rng.random() < 0.03:  # burst dip
            d0 = int(rng.integers(0, L))
            d1 = min(L, d0 + int(rng.integers(3, 15)))
            q[d0:d1] -= rng.integers(8, 20)
        q = np.clip(q, 2, qual_levels - 1).astype(np.uint8)
        q[nmask] = 2
        if qual_bins is not None:
            # binned calibration (NovaSeq-style): snap to nearest bin
            binsv = np.asarray(sorted(qual_bins), dtype=np.int32)
            q = binsv[np.argmin(np.abs(q[:, None].astype(np.int32)
                                       - binsv[None, :]), axis=1)] \
                .astype(np.uint8)
        qual = (q + 33).tobytes()
        out += b"@" + rid + b"\n" + seq.tobytes() + b"\n+\n" + qual + b"\n"
    return bytes(out)


# --- named corpora for the size-regression harness (SURVEY.md §4 item 5) ---

def corpus(name: str, num_reads: int, seed: int = 0) -> bytes:
    """Diverse named corpora so compression-ratio regressions are caught
    on more than one data shape (round-1 VERDICT missing #3)."""
    if name == "illumina":
        return synth_fastq(num_reads, read_len=100, seed=seed,
                           n_rate=0.0005)
    if name == "novaseq":
        # 2-channel chemistry: 4 quality bins only. Low coverage (2x):
        # the default tiny shared genome would let LZ77 match whole reads
        # verbatim, which real gigabase-genome data never allows.
        return synth_fastq(num_reads, read_len=150, seed=seed,
                           n_rate=0.0005, qual_bins=[2, 12, 23, 37],
                           genome_size=num_reads * 150 // 2)
    if name == "longread":
        # 10kb-class reads, wide quality alphabet (forces the 7-bit tree)
        return synth_fastq(num_reads, read_len=10000, seed=seed,
                           var_len=True, n_rate=0.001, qual_levels=90)
    if name == "nheavy":
        # low-quality run: ~5% of bases are N, in bursts
        return synth_fastq(num_reads, read_len=100, seed=seed,
                           n_rate=0.05, n_burst=True)
    if name == "sra":
        return synth_fastq(num_reads, read_len=100, seed=seed,
                           n_rate=0.0005, id_style="sra")
    raise ValueError(f"unknown corpus {name!r}")


CORPORA = ("illumina", "novaseq", "longread", "nheavy", "sra")
