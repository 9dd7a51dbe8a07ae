"""The port's native matcher (native/host.cpp's match_find, behind
native.match_find_arrays) against its faults: an index table that fills
(an L4 encode that never returns), a candidate arena that passes the
27-bit block field of a slot (candidate walks that change from run to
run), an unchecked realloc, and a sampling mask read in two places. Each
case that could hang or exhaust memory runs in a child process under a
timeout."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import native
from slimfastq_tpu_torch.models import matcher as M
from slimfastq_tpu_torch.utils.fastq import parse_fastq_bytes
from slimfastq_tpu_torch.utils.synth import corpus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sampled_kmer_fastq(n: int = 2048, seed: int = 0) -> bytes:
    """n reads of 16 bp, each a distinct 16-mer that the default mask
    samples (mix64(k) & 15 == 0): every read is one key of the index,
    16 times the keys its first sizing expects."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, size=64 * n, dtype=np.uint64)
    k = k[(M._mix64(k) & np.uint64(15)) == 0]
    _, first = np.unique(k, return_index=True)
    k = k[np.sort(first)][:n]
    shifts = np.uint64(2) * np.arange(15, -1, -1, dtype=np.uint64)
    codes = ((k[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    qual = rng.integers(35, 74, size=(n, 16), dtype=np.uint8)
    return b"".join(b"@s%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(),
                                           qual[i].tobytes())
                    for i in range(n))


def _child(code: str, timeout: float, env=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


_L4_CHILD = """
from slimfastq_tpu_torch import api
d = open({src!r}, "rb").read()
e = api.encode_fastq(d, level=4, device="cpu")
assert api.decode_fastq(e, device="cpu") == d
open({dst!r}, "wb").write(e)
"""


def test_l4_encode_returns_on_sampled_kmers(tmp_path):
    """2,048 reads whose 16-mers the mask all samples: the index's first
    table has 512 slots for 2,048 keys. The native L4 encode (in a child,
    60 s) returns, decodes exactly, and equals the pure-Python pipeline's
    container, the NumPy oracle's and the JAX package's oracle path's."""
    data = sampled_kmer_fastq()
    assert len(data) == 86954
    src, dst = str(tmp_path / "in.fq"), str(tmp_path / "native.sfq")
    with open(src, "wb") as f:
        f.write(data)
    r = _child(_L4_CHILD.format(src=src, dst=dst), timeout=60)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(dst, "rb") as f:
        enc = f.read()
    assert enc == tapi.encode_fastq(data, level=4, device="cpu",
                                    use_native=False)
    assert enc == tapi.encode_fastq(data, level=4, backend="oracle")
    assert enc == japi.encode_fastq(data, level=4, use_native=False)


_ARENA_CHILD = """
import json
import numpy as np
from slimfastq_tpu_torch import native
from slimfastq_tpu_torch.models import matcher as M
n, L, copies = 3072, 16500, 8
rng = np.random.default_rng(0)
seq = np.frombuffer(b"ACGT", dtype=np.uint8)[
    rng.integers(0, 4, size=(n, L), dtype=np.uint8)]
seq = np.ascontiguousarray(np.concatenate([seq, seq[n - copies:]]))
m = len(seq)
ref, orient, v, score = native.match_find_arrays(
    seq.reshape(-1), np.arange(m, dtype=np.int64) * L,
    np.full(m, L, dtype=np.int64), min(M.THRESHOLDS))
hit = np.flatnonzero(ref >= 0)
print(json.dumps({
    "matched": hit.tolist(),
    "found": [(int(ref[i]), int(orient[i]), int(v[i]), int(score[i]))
              for i in hit]}))
"""


def test_arena_past_2_27_entries_repeats():
    """3,072 random reads of 16.5 kb plus copies of the last 8, every
    position sampled (SFQ_MATCH_SAMPLE_MASK=0, which the wrapper reads
    through matcher.sample_mask()): the candidate arena ends near 201 M
    entries, past 2^27. With 1 and twice with 8 OpenMP threads the
    matcher walks and scores the same candidates and gives the same
    matches; each copy matches its original whole."""
    runs = []
    for threads in (1, 8, 8):
        r = _child(_ARENA_CHILD, timeout=300, env={
            "SFQ_MATCH_SAMPLE_MASK": "0", "SFQ_MATCH_STATS": "1",
            "OMP_NUM_THREADS": str(threads)})
        assert r.returncode == 0, r.stderr[-4000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        stats = [ln for ln in r.stderr.splitlines()
                 if ln.startswith("match_find:")]
        assert len(stats) == 1, r.stderr[-4000:]
        counts = stats[0].split("|")[1].split()
        out["stats"] = dict(zip(counts[::2], map(int, counts[1::2])))
        runs.append(out)
    first = runs[0]
    # mask 0: the 2,056 reads past the first chunk probe every 16-mer of
    # both orientations
    assert first["stats"]["probes"] == 2 * (3080 - 1024) * (16500 - 15)
    assert first["stats"]["cand-walks"] > 0 and first["stats"]["scored"] > 0
    for other in runs[1:]:
        assert other["stats"] == first["stats"]
        assert (other["matched"], other["found"]) == \
            (first["matched"], first["found"])
    assert first["matched"] == list(range(3072, 3080))
    assert first["found"] == [[3064 + i, 0, 0, 16500] for i in range(8)]


@pytest.fixture(scope="module")
def coverage():
    """1,280 reads of 150 bp at 2x coverage (two matcher chunks)."""
    data = corpus("novaseq", 1280, seed=3)
    codes = [M._B2C0[np.frombuffer(s, dtype=np.uint8)]
             for s in parse_fastq_bytes(data).seqs]
    idx, n = native.fastq_index(data)
    return np.frombuffer(data, dtype=np.uint8), idx, codes


@pytest.mark.parametrize("mask", [None, "7"])
def test_native_matcher_equals_oracle(coverage, monkeypatch, mask):
    """native.match_find equals models/matcher.find_matches, selection and
    tie-breaks included, under the default mask and under a mask set
    after both modules were imported (both read it through
    matcher.sample_mask() when called)."""
    buf, idx, codes = coverage
    args = (buf, idx["seq_off"], idx["seq_len"], min(M.THRESHOLDS))
    monkeypatch.delenv("SFQ_MATCH_SAMPLE_MASK", raising=False)
    default = native.match_find(*args)
    if mask is not None:
        monkeypatch.setenv("SFQ_MATCH_SAMPLE_MASK", mask)
    assert M.sample_mask() == int(mask or 15)
    got = native.match_find(*args)
    assert got == M.find_matches(codes)
    assert sum(m is not None for m in got) > 32
    assert (got != default) == (mask is not None)


_REALLOC_CHILD = """
import resource
import numpy as np
from slimfastq_tpu_torch import native
n, L = 256, 4096
rng = np.random.default_rng(1)
data = np.frombuffer(b"ACGT", dtype=np.uint8)[
    rng.integers(0, 4, size=n * L, dtype=np.uint8)]
off = np.arange(n, dtype=np.int64) * L
ln = np.full(n, L, dtype=np.int64)
native.match_find_arrays(data[:64 * L], off[:64], ln[:64], 48)  # warm
with open("/proc/self/status") as f:
    vm = next(int(s.split()[1]) for s in f if s.startswith("VmSize:"))
# every position sampled: the index's table takes 2^21 slots (16.8 MB),
# then its candidate arena 5.2 M entries (41.8 MB), which must not fit
limit = (vm << 10) + (30 << 20)
resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
try:
    native.match_find_arrays(data, off, ln, 48)
except MemoryError as e:
    print("MemoryError:", e)
"""


def test_realloc_failure_raises_memory_error():
    """The candidate arena's realloc fails under an address-space limit
    set just above the child's size: match_find_arrays raises
    MemoryError, and the child exits normally, not by a signal."""
    r = _child(_REALLOC_CHILD, timeout=120, env={
        "SFQ_MATCH_SAMPLE_MASK": "0", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, (r.returncode, r.stderr[-4000:])
    assert "MemoryError: match_find: the candidate arena's realloc" \
        in r.stdout, r.stdout + r.stderr[-4000:]
