"""Block parallelism over a node's cards (the JAX package's
parallel/mesh.py).

A ``Mesh`` is a tuple of devices, its ``"blocks"`` axis: entry i is shard
i. A list of B blocks is split into ``mesh.size`` contiguous runs that
differ by at most one block, in mesh order (``runs``: the JAX package's
``NamedSharding(mesh, P("blocks"))`` after ``_pad_blocks``). The port pads
no dummy block: each block carries its own step count in a launch, so
padding would only add work. Every block carries its own adaptive state,
so the shards need no communication while they code.

``map_blocks`` runs one function per shard on its run of blocks, each
shard on a host thread of its own with its card current and a CUDA
stream of its own, and joins the shards' results in block order; a lone
shard runs on the calling thread. One device may appear more than once
in a mesh, each entry one shard: the CPU tests build a mesh of 8 CPU
entries (the JAX package's tests run on 8 virtual CPU devices), and a
one-card machine can build a two-shard mesh on its card.

The four stream-level functions below are the mesh form of the JAX
package's ``_build_sharded_*`` programs: with ``mesh=None`` they are the
single-card window launches of streams_torch's ``*_blocks`` entries on
``device``; with a mesh, each shard runs those launches (Kernels E, D
and C over its own blocks) on its own card. The bytes are the
sequential ones either way.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from ..ops import _cuda, streams_torch


@dataclass(frozen=True)
class Mesh:
    """The devices of the ``"blocks"`` axis, one shard each."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (any torch devices; one may appear more
    than once) or, by default, over cuda:0 .. cuda:{device_count()-1},
    the first ``n_devices`` of them where that is given. A CUDA entry
    needs its card: without one this raises, and no shard runs on the
    CPU in its place."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh: pass devices "
                               "(e.g. ['cpu'] * 8) to shard on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh entry {d}: no CUDA device")
            if d.index is None:
                raise ValueError(f"mesh entry {d}: name the card's index")
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh entry {d}: the node has "
                                   f"{torch.cuda.device_count()} cards")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh entry {d}")
    return Mesh(devs)


def runs(n: int, k: int) -> list:
    """The n blocks' split over k shards: k contiguous ranges, in order,
    whose lengths differ by at most one (the longer first)."""
    base, rem = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + base + (i < rem)
        out.append(range(lo, hi))
        lo = hi
    return out


def shares(mesh: Mesh, device) -> int:
    """How many of the mesh's shards code on ``device``."""
    return mesh.devices.count(torch.device(device))


def budgets(mesh: Mesh) -> list:
    """Each shard's device-byte budget (streams_torch.device_budget, per
    card, split among the shards that share the card)."""
    return [streams_torch.device_budget(d) // shares(mesh, d)
            for d in mesh.devices]


def fits(sizes, shard_budgets) -> bool:
    """Whether a window of blocks of these device bytes, split over the
    shards as ``runs`` splits it, keeps every shard within its budget (a
    shard's one block may pass it alone)."""
    return all(len(r) < 2 or sum(sizes[i] for i in r) <= b
               for r, b in zip(runs(len(sizes), len(shard_budgets)),
                               shard_budgets))


# one worker thread per shard index, kept for the process: a shard keeps
# its thread, its CUDA stream and its pool of side streams from one window
# to the next, so the caching allocator reuses its blocks
_WORKERS: dict = {}
_WORKERS_LOCK = threading.Lock()
_LOCAL = threading.local()  # a worker's CUDA stream by device
# CPU shards take turns: the plain versions are loops of small tensor ops,
# which threads running at once slow several-fold in GIL hand-offs
_CPU_TURN = threading.Lock()


def _worker(i: int) -> ThreadPoolExecutor:
    with _WORKERS_LOCK:
        ex = _WORKERS.get(i)
        if ex is None:
            ex = _WORKERS[i] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"sfq-shard{i}")
        return ex


def _shard_stream(dev: torch.device):
    """This thread's own CUDA stream on ``dev``: a shard's work does not
    queue behind another shard's on the card's default stream."""
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]


def _run_shard(mesh: Mesh, i: int, fn, idx, own_stream: bool):
    """fn(idx, device) as shard i: its card current, its device budget
    split among the shards on that card, its launches counted as shard
    i's."""
    dev = mesh.devices[i]
    cuda = dev.type == "cuda"
    with torch.cuda.device(dev) if cuda else _CPU_TURN, \
            torch.cuda.stream(_shard_stream(dev)) if cuda and own_stream \
            else nullcontext(), \
            streams_torch.card_share(shares(mesh, dev)), \
            _cuda.as_shard(i):
        return fn(list(idx), dev)


def map_blocks(mesh: Mesh, n: int, fn) -> list:
    """fn(block indices, device) on each shard's run of the n blocks (a
    list of per-block results each), every shard that holds a block on
    its own host thread, or on the calling thread where only one does;
    the results joined in block order. A shard's error is raised once
    every shard has ended."""
    parts = [(i, r) for i, r in enumerate(runs(n, mesh.size)) if len(r)]
    if len(parts) <= 1:
        return [x for i, r in parts for x in _run_shard(mesh, i, fn, r,
                                                        False)]
    futs = [_worker(i).submit(_run_shard, mesh, i, fn, r, True)
            for i, r in parts]
    wait(futs)
    return [x for f in futs for x in f.result()]


def _take(xs, idx):
    return None if xs is None else [xs[i] for i in idx]


def encode_stream_blocks(kind: str, geom, mesh: Mesh | None, syms_list,
                         counts_list, pos_list=None, reset_list=None,
                         mflag_list=None, *, device=None) -> list:
    """Per block (payload, lens) of one host-modelled stream (mflag_list:
    per block a format-v5 SEQ stream's match-span flags or None)."""
    def run(idx, dev):
        return streams_torch.encode_stream_blocks(
            kind, geom, _take(syms_list, idx), _take(counts_list, idx), dev,
            _take(pos_list, idx), _take(reset_list, idx),
            _take(mflag_list, idx))
    if mesh is None:
        return run(range(len(syms_list)), device)
    return map_blocks(mesh, len(syms_list), run)


def encode_seq_qual_raw_blocks(sgeom_list, mesh: Mesh | None, raw_list,
                               counts_list, qgeom_list, minq_list, seq_map,
                               *, device=None) -> list:
    """Per block {"SEQ": (payload, lens), "QUAL": ...} from raw bytes."""
    def run(idx, dev):
        return streams_torch.encode_seq_qual_raw_blocks(
            _take(sgeom_list, idx), _take(raw_list, idx),
            _take(counts_list, idx), _take(qgeom_list, idx),
            _take(minq_list, idx), seq_map, dev)
    if mesh is None:
        return run(range(len(raw_list)), device)
    return map_blocks(mesh, len(raw_list), run)


def decode_seq_qual_raw_blocks(sgeom_list, mesh: Mesh | None, pay_s, lens_s,
                               pay_q, lens_q, ll_list, counts_list,
                               starts_list, lengths_list, totals, qgeom_list,
                               minq_list, seq_map, *, device=None) -> list:
    """Per block (seq_bytes, qual_bytes), record-major."""
    per_block = (sgeom_list, pay_s, lens_s, pay_q, lens_q, ll_list,
                 counts_list, starts_list, lengths_list, totals, qgeom_list,
                 minq_list)

    def run(idx, dev):
        return streams_torch.decode_seq_qual_raw_blocks(
            *(_take(xs, idx) for xs in per_block), seq_map, dev)
    if mesh is None:
        return run(range(len(pay_s)), device)
    return map_blocks(mesh, len(pay_s), run)


def decode_stream_blocks(kind: str, geom, mesh: Mesh | None, payload_list,
                         lens_list, counts_list, steps_list, pos_list=None,
                         reset_list=None, *, device=None) -> list:
    """Per block [steps, W] u8 symbols of one host-modelled stream."""
    def run(idx, dev):
        return streams_torch.decode_stream_blocks(
            kind, geom, _take(payload_list, idx), _take(lens_list, idx),
            _take(counts_list, idx), _take(steps_list, idx), dev,
            _take(pos_list, idx), _take(reset_list, idx))
    if mesh is None:
        return run(range(len(payload_list)), device)
    return map_blocks(mesh, len(payload_list), run)
