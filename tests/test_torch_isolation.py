"""Isolation and drift guards of the port: slimfastq_tpu_torch (its entry
points, entry.py, included), chip_smoke.py and the port's tools
(tools/*_torch.py) import neither JAX nor the JAX package, and the port's
copy of the native host library stays byte-identical to the reference's
outside the matcher span (the port repairs its matcher; the reference
keeps its own)."""

import ast
import hashlib
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "slimfastq_tpu_torch")
TOOLS = ("bench_1gb_torch", "profile_wall_torch", "longread_l4_torch")


def _refused(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "slimfastq_tpu") or top.startswith("jax")


def _imports(path: str):
    """Every module name an `import` or `from ... import` in the file names,
    at any depth (lazy imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_sources_import_no_jax():
    bad = [(os.path.relpath(p, ROOT), m)
           for p in [*_port_sources(), os.path.join(ROOT, "chip_smoke.py"),
                     *(os.path.join(ROOT, "tools", t + ".py")
                       for t in TOOLS)]
           for m in _imports(p) if _refused(m)]
    assert not bad, bad


def test_chip_smoke_names_no_reference_module():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "slimfastq_tpu." not in src
    assert "import jax" not in src


_BLOCKER = r'''
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top.startswith("jax") or top == "slimfastq_tpu":
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
'''

_ROUND_TRIP = r'''
import torch
torch.set_num_threads(1)
import slimfastq_tpu_torch.api as api
import slimfastq_tpu_torch.cli  # noqa: F401
from slimfastq_tpu_torch.utils.synth import synth_fastq
import slimfastq_tpu_torch.parallel.mesh  # noqa: F401
import slimfastq_tpu_torch.parallel.sharded  # noqa: F401
import slimfastq_tpu_torch.parallel.gather  # noqa: F401
import slimfastq_tpu_torch.parallel.multihost  # noqa: F401
data = synth_fastq(6, read_len=20, seed=1)
enc = api.encode_fastq(data, device="cpu", lanes=4, aux_lanes=4)
assert api.decode_fastq(enc, device="cpu") == data
# a window of three blocks, then the streaming encode and decode
kw = dict(lanes=4, aux_lanes=4, block_records=2)
win = api.encode_fastq(data, device="cpu", **kw)
assert api.decode_fastq(win, device="cpu") == data
import os, tempfile
with tempfile.TemporaryDirectory() as d:
    src, dst, back = (os.path.join(d, f) for f in ("a.fq", "a.sfq", "b.fq"))
    open(src, "wb").write(data)
    api.encode_file_streaming(src, dst, device="cpu", chunk_bytes=50, **kw)
    assert open(dst, "rb").read() == win
    api.decode_file_streaming(dst, back, device="cpu")
    assert open(back, "rb").read() == data
import chip_smoke
import slimfastq_tpu_torch.entry as entry
from tools import bench_1gb_torch, longread_l4_torch, profile_wall_torch
fn, args = entry.entry(device="cpu")
fn(*args)
if not torch.cuda.is_available():
    assert chip_smoke.main() == 1
    for call in (entry.entry, lambda: entry.dryrun_multichip(1)):
        try:
            call()
            raise AssertionError("ran without a card")
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
    for tool in (bench_1gb_torch, longread_l4_torch, profile_wall_torch):
        assert tool.main() == 1
bad = [m for m in sys.modules
       if m.split(".")[0] == "slimfastq_tpu" or m.startswith("jax")]
assert not bad, bad
print("isolated round trip ok")
'''


def test_port_runs_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _BLOCKER + _ROUND_TRIP],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "isolated round trip ok" in r.stdout
    assert '"ok"' not in r.stdout  # chip_smoke printed no result


# SHA-256 of the reference's native/host.cpp, which this round keeps as
# it is (its matcher keeps the faults the port's copy repairs)
REF_HOST_CPP_SHA256 = \
    "c4d1950fde5be7546a82bd99f5ab1045e80d17cb24470c8ad863f51177b219bb"


def _matcher_span(src: bytes) -> tuple:
    """(before, span, after) of a host.cpp: the span runs from the
    matcher's first constant (`static const int MK = 16;`) to the closing
    brace of `match_find`."""
    a = src.index(b"static const int MK = 16;")
    b = src.index(b"\nint64_t match_find(", a)
    e = src.index(b"\n}\n", b) + 3
    return src[:a], src[a:e], src[e:]


def test_host_cpp_equals_reference_outside_matcher():
    """The port's native/host.cpp equals the reference's but in the
    matcher span, and the reference's file is the one of this pin."""
    with open(os.path.join(ROOT, "slimfastq_tpu", "native", "host.cpp"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(PORT, "native", "host.cpp"), "rb") as f:
        port = f.read()
    assert hashlib.sha256(ref).hexdigest() == REF_HOST_CPP_SHA256
    (rb, _, ra), (pb, _, pa) = _matcher_span(ref), _matcher_span(port)
    assert (pb, pa) == (rb, ra)


@pytest.mark.parametrize("name", ["coder.cu", "compact.cu", "encode.cu"])
def test_cuda_sources_carry_their_note(name):
    """Each kernel source opens with the note that says what it replaces
    and what bounds it."""
    with open(os.path.join(PORT, "csrc", name)) as f:
        head = f.read(4000)
    assert "Replaces:" in head and "Bound on the H100" in head
