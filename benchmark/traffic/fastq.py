"""The benchmark's FASTQ traffic: files of Illumina-like or long reads,
made in bulk with NumPy from a seed.

The model is that of the port's test generator
(``slimfastq_tpu_torch.utils.synth.synth_fastq``), re-written here so
that one file of a million reads takes seconds rather than a minute and
so that the benchmark's inputs do not come from the program under test:

- reads sampled from a synthetic genome with planted repeats, half of
  them reverse-complemented, with substitution errors at ``error_rate``;
- N at ``n_rate`` per base (its quality 2);
- qualities: a position ramp, per-cycle systematics shared by all reads,
  a per-read offset, autocorrelated noise pinned at both ends of the
  read, and dips in ``dip_share`` of the reads, clipped to
  [2, qual_levels - 1], Phred+33;
- Illumina IDs ``@<instrument>:23:H7QQQ:1:1101:<x>:<y>``.

The read lengths come from the workload's ``shape_seed`` and not from the
run's seed, so every seed gives the same sizes (the same blocks, lanes
and steps) and only the content moves. The draws differ from
``synth_fastq``'s, so the bytes do too.
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), *keys]))


def read_lengths(params: dict, file_index: int) -> np.ndarray:
    """The lengths of one file's reads: the same for every run seed."""
    n = int(params["reads"])
    spec = params["read_length"]
    if "value" in spec:
        return np.full(n, int(spec["value"]), dtype=np.int64)
    rng = _rng(params["shape_seed"], file_index)
    return rng.integers(int(spec["min"]), int(spec["max"]) + 1, size=n,
                        dtype=np.int64)


def _genome(rng, size: int) -> np.ndarray:
    g = rng.integers(0, 4, size=size, dtype=np.uint8)
    n_rep = size // 2000
    lens = rng.integers(200, 2000, size=n_rep)
    src = rng.integers(0, np.maximum(size - lens, 1))
    dst = rng.integers(0, np.maximum(size - lens, 1))
    for L, s, d in zip(lens.tolist(), src.tolist(), dst.tolist()):
        g[d:d + L] = g[s:s + L]
    return g


def _digits(v: np.ndarray) -> np.ndarray:
    nd = np.ones(len(v), dtype=np.int64)
    for k in range(1, 19):
        nd += v >= 10 ** k
    return nd


def _sites(rng, lens: np.ndarray, width: int, rate: float):
    """(read, position) pairs hit at ``rate`` a base, drawn over the
    [reads, width] grid and kept inside each read."""
    n = len(lens)
    flat = rng.integers(0, n * width, size=rng.binomial(n * width, rate))
    r, p = np.divmod(flat, width)
    keep = p < lens[r]
    return r[keep], p[keep]


def _bases(rng, params: dict, lens: np.ndarray) -> tuple:
    """[reads, width] uint8 bases (past a read's end: filler) and the
    (read, position) pairs that hold N."""
    n, width = len(lens), int(lens.max())
    total = int(lens.sum())
    size = max(int(total * float(params["genome_per_base"])),
               10 * width) + 2 * width
    genome = _genome(rng, size)
    windows = np.lib.stride_tricks.sliding_window_view(genome, width)
    rev = rng.random(n) < float(params["revcomp_share"])
    g0 = rng.integers(width, size - width, size=n)
    # a reverse read ends where its forward window would: reversed, the
    # window's first lens[r] bases are the read
    codes = windows[np.where(rev, g0 + lens - width, g0)]
    codes[rev] = _COMP[codes[rev, ::-1]]
    r, p = _sites(rng, lens, width, float(params["error_rate"]))
    codes[r, p] = (codes[r, p] + rng.integers(1, 4, size=len(r),
                                              dtype=np.uint8)) % 4
    seq = _ACGT[codes]
    nr, npos = _sites(rng, lens, width, float(params["n_rate"]))
    seq[nr, npos] = ord("N")
    return seq, (nr, npos)


def _quals(rng, params: dict, lens: np.ndarray, n_sites) -> np.ndarray:
    """[reads, width] uint8 Phred+33 qualities. The noise's steps are
    uniform with the model's deviation of 0.6 (its walk is near normal
    after a few steps, and uniform draws cost a fifth of normal ones)."""
    n, width = len(lens), int(lens.max())
    pos = np.arange(width, dtype=np.float32)
    sys_pos = np.cumsum(rng.normal(0, 0.35, size=width + 1))
    sys_pos -= sys_pos.mean()
    sys_pos = np.clip(sys_pos, -4, 4).astype(np.float32)[:width]
    q = rng.random((n, width), dtype=np.float32)
    q -= 0.5
    q *= np.float32(0.6 * 12 ** 0.5)
    np.cumsum(q, axis=1, out=q)
    last = q[np.arange(n), lens - 1][:, None]
    lf = lens.astype(np.float32)[:, None]
    if (lens == width).all():  # one ramp for every read
        frac = pos / np.float32(width)
        q += 38.0 - 8.0 * frac * frac + sys_pos
        q -= pos / np.float32(max(width - 1, 1)) * last
    else:
        frac = pos[None, :] / lf
        q += 38.0 - 8.0 * frac * frac
        del frac
        q += sys_pos
        q -= pos[None, :] / np.maximum(lf - 1, 1) * last
    q += rng.normal(0, 2.0, size=(n, 1)).astype(np.float32)
    dip = np.flatnonzero(rng.random(n) < float(params["dip_share"]))
    d0 = rng.integers(0, lens[dip])[:, None]
    d1 = np.minimum(lens[dip][:, None],
                    d0 + rng.integers(3, 15, size=(len(dip), 1)))
    depth = rng.integers(8, 20, size=(len(dip), 1)).astype(np.float32)
    q[dip] -= depth * ((pos[None, :] >= d0) & (pos[None, :] < d1))
    np.clip(q, 2, int(params["qual_levels"]) - 1, out=q)
    qual = q.astype(np.uint8)
    del q
    qual[n_sites] = 2
    qual += 33
    return qual


def make_file(params: dict, seed: int, file_index: int) -> bytes:
    """One FASTQ file of the workload, from the run's seed."""
    rng = _rng(seed, file_index)
    lens = read_lengths(params, file_index)
    n = len(lens)
    seq, n_sites = _bases(rng, params, lens)
    qual = _quals(rng, params, lens, n_sites)
    x = 1000 + np.cumsum(rng.integers(1, 4, size=n))
    y = 2000 + np.arange(n) % 997
    prefix = np.frombuffer(b"@" + params["instrument"].encode()
                           + b":23:H7QQQ:1:1101:", dtype=np.uint8)
    xd, yd = _digits(x), _digits(y)
    rec = len(prefix) + xd + 1 + yd + 1 + lens + 3 + lens + 1
    # runs of records of one length (x grows, so its digits change
    # rarely): each run is a [records, length] array filled by columns
    cut = np.flatnonzero((np.diff(rec) != 0) | (np.diff(xd) != 0)) + 1
    bounds = np.concatenate([[0], cut, [n]])
    out = np.empty(int(rec.sum()), dtype=np.uint8)
    at = 0
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        k, width, L = b - a, int(rec[a]), int(lens[a])
        blk = out[at:at + k * width].reshape(k, width)
        at += k * width
        c = len(prefix)
        blk[:, :c] = prefix
        for v, nd in ((x[a:b], int(xd[a])), (y[a:b], int(yd[a]))):
            for j in range(nd):
                blk[:, c + j] = 48 + (v // 10 ** (nd - 1 - j)) % 10
            blk[:, c + nd] = ord(":")
            c += nd + 1
        blk[:, c - 1] = 10
        blk[:, c:c + L] = seq[a:b, :L]
        c += L
        blk[:, c:c + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
        c += 3
        blk[:, c:c + L] = qual[a:b, :L]
        blk[:, c + L] = 10
    return out.tobytes()


def make_files(params: dict, seed: int) -> list:
    """The workload's ``files`` distinct files for this seed."""
    return [make_file(params, seed, i) for i in range(int(params["files"]))]
