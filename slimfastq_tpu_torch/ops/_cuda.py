"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain ``extern "C"`` interface (``csrc/build/lib<name>.so``), loaded
with ctypes. A library is rebuilt when its source is newer than it.
Pointers and the CUDA stream pass as ``c_void_p``; every C entry returns
``cudaGetLastError()`` after its launch and ``check`` raises on non-zero.
``launch`` calls an entry with its tensors' card current.

Launch counts: every kernel wrapper adds one to ``launches[name]`` where
it launches its kernel, and nowhere else, so a run can show which kernels
its path went through; ``descs[name]`` adds up the descriptors those
launches took (blocks for Kernels E and D, streams for Kernel C), so a
window's launches show how many blocks each carried; ``by_shard`` the
launches of each shard of a mesh, by its device. Kernel E counts each
launch set (one stream of a window's blocks) as ``lane_encode``, the one
host call that issues its slices as ``encode_run`` (its descriptors: the
slices), and each phase's launch of a slice under its own name
(``encode_rows``, ``encode_touches``, ``encode_sort``,
``encode_entry_scan``, ``encode_gather``, ``encode_code``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD = os.path.join(CSRC, "build")
SOURCES = ("coder", "compact", "encode", "lanes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"lane_encode": 0, "lane_decode": 0, "compact_lanes_dev": 0,
            "lane_layout": 0, "lane_unpack": 0, "encode_rows": 0,
            "encode_touches": 0, "encode_sort": 0, "encode_entry_scan": 0,
            "encode_gather": 0, "encode_code": 0, "encode_run": 0}
descs = dict.fromkeys(launches, 0)
# launches by mesh shard: (shard, device) -> {name: launches}, where a
# shard of parallel.mesh made them (as_shard)
by_shard: dict = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_where = threading.local()  # .shard: the mesh shard this thread codes


def count(name: str, n: int, device) -> None:
    """One launch of kernel ``name`` on ``device`` over ``n``
    descriptors (the shards of a mesh count from their own threads)."""
    count_many({name: (1, n)}, device)


def count_many(made: dict, device) -> None:
    """``made[name]`` = (launches, descriptors) of each kernel, on
    ``device``, in one update."""
    with _count_lock:
        shard = getattr(_where, "shard", None)
        tally = (None if shard is None else
                 by_shard.setdefault((shard, str(device)), {}))
        for name, (k, n) in made.items():
            launches[name] += k
            descs[name] += n
            if tally is not None:
                tally[name] = tally.get(name, 0) + k


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = descs[k] = 0
        by_shard.clear()


@contextmanager
def as_shard(i: int):
    """Count this thread's launches as mesh shard i's too (by_shard)."""
    prev = getattr(_where, "shard", None)
    _where.shard = i
    try:
        yield
    finally:
        _where.shard = prev


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled from csrc/ at first use")
    return path


def _so(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Whether lib<name>.so is older than its source or a header of
    csrc/ (ctx.cuh: what Kernels E and D share)."""
    so = _so(name)
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(d) for d in deps)


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source, one nvcc process each, all started
    together. Returns each built library's ptxas report (registers,
    shared memory, spills)."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{_so(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), tmp)
    reports, errors = {}, []
    for n, (p, tmp) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed:\n{out}{err}")
            continue
        os.replace(tmp, _so(n))
        reports[n] = err
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first use), with
    argtypes set from ``signatures`` and an int (cudaError_t) restype."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_so(name))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            for fn, args in signatures.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = args
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def launch(t: torch.Tensor, entry, *args) -> int:
    """entry(*args, stream) of a C wrapper on t's card, on PyTorch's
    current stream there. The C wrappers launch (and set a kernel's
    shared-memory attribute) on the calling thread's current device, so
    t's card is made current for the call: a launch lands on its tensors'
    card whatever thread makes it (the shard threads of a mesh)."""
    with torch.cuda.device(t.device):
        return entry(*args, torch.cuda.current_stream(t.device).cuda_stream)


PTR = ctypes.c_void_p
INT = ctypes.c_int
