"""The multi-process workflow of the port on CPU processes (the JAX
package's tests/test_multihost.py, test_gather.py and
test_multiprocess.py, ported to torch.distributed with the gloo backend):
block ranges per process, shard containers merged into the
single-process container, the ordered ragged gather (two all_gather
calls), shards carried by the gather and merged, and initialize's
checks.

The multi-process cases run this file as a script, one process per rank
(``python tests/test_torch_multihost.py MODE RANK WORLD PORT OUTDIR``),
each under its own timeout, so a rendezvous that hangs fails its test."""

import ast
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import native  # built here, before any worker
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.parallel import gather, multihost
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=64, aux_lanes=16, block_records=48)
WORKER_TIMEOUT = 240  # seconds a worker may take, rendezvous included


def _data() -> bytes:
    """Five blocks of 48 records, the last ragged (13)."""
    return synth_fastq(4 * 48 + 13, read_len=30, seed=21, var_len=True,
                       n_rate=0.01)


def _records(data: bytes, lo: int, hi: int) -> bytes:
    """The FASTQ bytes of records [lo, hi) of ``data``."""
    idx, n = native.fastq_index(data)
    start = int(idx["id_off"][lo]) - 1
    end = int(idx["id_off"][hi]) - 1 if hi < n else len(data)
    return data[start:end]


def _payloads(rank: int) -> bytes:
    """Rank r's ragged payload for the gather test (rank 1's is empty)."""
    rng = np.random.default_rng(100 + rank)
    n = 0 if rank == 1 else int(rng.integers(1, 5000))
    return rng.integers(0, 256, size=n).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _worker(mode: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    calls = []
    real = dist.all_gather

    def spy(tensors, tensor, group=None, **kw):
        calls.append((tensor.dtype, tensor.device.type, len(tensors)))
        return real(tensors, tensor, group=group, **kw)
    dist.all_gather = spy
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    multihost.initialize(f"127.0.0.1:{port}", world, rank)  # quiet again
    try:
        if mode == "encode":
            data = _data()
            _, n = native.fastq_index(data)
            ranges = multihost.process_block_ranges(
                n, CFG["block_records"], world, rank)
            part = b"".join(_records(data, lo, hi) for lo, hi in ranges)
            shard = tapi.encode_fastq(part, cfg=config_for_level(3, **CFG),
                                      device="cpu")
            with open(os.path.join(out, f"shard{rank}.sfq"), "wb") as f:
                f.write(shard)
            parts = gather.ragged_all_gather(shard, return_parts=True)
            merged = multihost.merge_containers([p.tobytes() for p in parts])
        else:
            merged = gather.ragged_all_gather(_payloads(rank))
        with open(os.path.join(out, f"{mode}{rank}.bin"), "wb") as f:
            f.write(merged)
        with open(os.path.join(out, f"calls{rank}.txt"), "w") as f:
            f.write(repr([(str(d), t, k) for d, t, k in calls]))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, world: int, out) -> None:
    """``world`` worker processes of ``mode``, each under its own
    timeout; fails (killing the rest) if any fails or hangs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(world), str(port), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r} timed out")
                break
            if p.returncode:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)


def test_process_block_ranges():
    """Contiguous runs of blocks per process, in process order, that
    cover every record once; counts differ by at most one block."""
    r = multihost.process_block_ranges(1000, 128, 3, 0)
    assert r == [(0, 128), (128, 256), (256, 384)]
    allr = sum((multihost.process_block_ranges(1000, 128, 3, p)
                for p in range(3)), [])
    assert allr[0][0] == 0 and allr[-1][1] == 1000
    for (a, b), (c, d) in zip(allr, allr[1:]):
        assert b == c
    sizes = [len(multihost.process_block_ranges(1000, 128, 3, p))
             for p in range(3)]
    assert max(sizes) - min(sizes) <= 1


@pytest.fixture(scope="module")
def single():
    """The single-process container of _data (the JAX package's, which
    the port's equals: tests/test_torch_api.py)."""
    from slimfastq_tpu import api as japi
    from slimfastq_tpu.config import config_for_level as jconfig_for_level
    from slimfastq_tpu.ops import streams_jax
    return japi.encode_fastq(_data(), cfg=jconfig_for_level(3, **CFG),
                             backend=streams_jax)


def test_merge_containers_equals_single_run(single, tmp_path):
    """Shard containers of two processes' block runs (3 + 2 blocks),
    encoded one after the other here, merged in process order: the
    single-process container; merge_container_files the same; shards of
    another config refused."""
    data = _data()
    _, n = native.fastq_index(data)
    shards = []
    for p in range(2):
        part = b"".join(_records(data, lo, hi) for lo, hi in
                        multihost.process_block_ranges(n, 48, 2, p))
        shards.append(tapi.encode_fastq(part, cfg=config_for_level(3, **CFG),
                                        device="cpu"))
    assert multihost.merge_containers(shards) == single
    paths = [str(tmp_path / f"s{i}.sfq") for i in range(2)]
    for pth, sb in zip(paths, shards):
        with open(pth, "wb") as f:
            f.write(sb)
    multihost.merge_container_files(paths, str(tmp_path / "m.sfq"))
    assert (tmp_path / "m.sfq").read_bytes() == single
    other = tapi.encode_fastq(b"", level=2, device="cpu")
    with pytest.raises(ValueError, match="headers differ"):
        multihost.merge_containers([shards[0], other])
    with pytest.raises(ValueError, match="no shards"):
        multihost.merge_containers([])


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_encode_gather_merge(world, single, tmp_path):
    """``world`` gloo processes (5 blocks: 3 + 2, or 2 + 2 + 1) each encode
    their run of blocks; their shard containers ride ragged_all_gather to
    every rank and merge there into the single-process container."""
    _run_ranks("encode", world, tmp_path)
    shards = [(tmp_path / f"shard{r}.sfq").read_bytes()
              for r in range(world)]
    assert multihost.merge_containers(shards) == single
    for r in range(world):
        assert (tmp_path / f"encode{r}.bin").read_bytes() == single


def test_ragged_all_gather_gloo(tmp_path):
    """Three gloo ranks, rank 1's payload empty: every rank gets the host
    concatenation in rank order, through two all_gather calls (the int64
    lengths, then the u8 payloads padded to the longest), on the CPU."""
    _run_ranks("gather", 3, tmp_path)
    want = b"".join(_payloads(r) for r in range(3))
    for r in range(3):
        assert (tmp_path / f"gather{r}.bin").read_bytes() == want
        calls = ast.literal_eval((tmp_path / f"calls{r}.txt").read_text())
        assert calls == [("torch.int64", "cpu", 3), ("torch.uint8", "cpu", 3)]


def test_initialize_checks(monkeypatch):
    """Explicit arguments are checked (a bad id or a missing count raises
    ValueError); with none and no torchrun environment the process stays
    single-process."""
    import torch.distributed as dist
    for pid, n in ((2, 2), (-1, 2), (0, None), (None, 2)):
        with pytest.raises(ValueError, match="invalid distributed"):
            multihost.initialize("127.0.0.1:1", n, pid, backend="gloo")
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
